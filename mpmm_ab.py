#!/usr/bin/env python3
"""Times this tree's ``mp_matmul`` kernel against another version of
``csrc/mpmm.cu`` on one card, in turns.

    python3 mpmm_ab.py --parent-src PATH [--report PATH]

``--parent-src`` is a ``mpmm.cu`` with the first design's C entry
(``mpmm_launch`` without a launch plan: one thread per output), for
example an older commit's file taken out with ``git show
<commit>:src/repro_torch/kernels/csrc/mpmm.cu``. It is
built with the port's own nvcc flags into ``build/ab/`` and loaded with
ctypes. Both versions run the fidelity config of ``fidelity_fp16_ipu``
on the same f16 operands:

* the decode sweep: qwen2-0.5b's 168 projections (24 layers x 7 shapes,
  each layer its own weights) at M = 8;
* the prefill wave: one layer's 7 projections at M = 256.

Each is replayed from a CUDA graph, median of 5, in the order parent,
change, change, parent; the two versions' outputs must be bit-equal.
Prints the card's name and power limit, then one JSON line of times in
ms. Needs a CUDA device and nvcc; without one it exits non-zero.
"""
import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LAYER = (("wq", 896, 896), ("wk", 896, 128), ("wv", 896, 128),
         ("wo", 896, 896), ("w_gate", 896, 4864), ("w_up", 896, 4864),
         ("w_down", 4864, 896))
N_LAYERS = 24


def build_parent(src):
    from repro_torch.kernels import _build
    text = open(src, "rb").read()
    out_dir = os.path.join(HERE, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "mpmm_parent-"
                       + hashlib.sha256(text).hexdigest()[:16] + ".so")
    if not os.path.exists(lib):
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                        src], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.mpmm_launch.argtypes = [P, P, P] + [I] * 10 + [P]
    so.mpmm_launch.restype = I
    return so


def parent_call(so, cfg):
    from repro_torch.core import fp16 as fpmod
    fmt = cfg.accum_format

    def call(a, b):
        m, k = a.shape
        n = b.shape[1]
        out = torch.empty((m, n), dtype=fpmod.native_dtype(fmt),
                          device=a.device)
        err = so.mpmm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, cfg.n,
            cfg.w, cfg.mask_threshold, 0, int(cfg.rounding == "floor"),
            fmt.exp_bits, fmt.mant_bits,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent mpmm_launch: cudaError_t {err}")
        return out
    return call


def graph_ms(fn, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mpmm_ab: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import mpmm
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = get_policy("fidelity_fp16_ipu").default.ipu
    versions = {"parent": parent_call(build_parent(args.parent_src), cfg),
                "change": lambda a, b: mpmm.mp_matmul(a, b, cfg)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    layers = [[(torch.randn((k, n), generator=gen, device="cuda")
                / k ** 0.5).to(torch.float16) for _, k, n in LAYER]
              for _ in range(N_LAYERS)]
    result = {"card": smi}
    for label, m, depth in (("decode_sweep_m8", 8, N_LAYERS),
                            ("layer_m256", 256, 1)):
        x = {k: (torch.randn((m, k), generator=gen, device="cuda") * 2
                 ).to(torch.float16) for k in (896, 4864)}

        def sweep(call):
            return [call(x[k], w) for layer in layers[:depth]
                    for (_, k, _), w in zip(LAYER, layer)]
        outs = {v: sweep(fn) for v, fn in versions.items()}
        for p, c in zip(outs["parent"], outs["change"]):
            if not torch.equal(p.view(torch.int32), c.view(torch.int32)):
                raise AssertionError(f"{label}: parent and change differ")
        turns = [(v, graph_ms(lambda: sweep(versions[v])))
                 for v in ("parent", "change", "change", "parent")]
        result[label] = {"turns_ms": turns,
                         "parent_ms": [t for v, t in turns if v == "parent"],
                         "change_ms": [t for v, t in turns if v == "change"],
                         "launches": len(outs["change"])}
        print(label, json.dumps(result[label]), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
