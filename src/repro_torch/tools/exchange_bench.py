"""The cross-pod gradient-exchange program at production scale (mirror
of ``tools/exchange_bench.py``; no card needed).

Runs ``parallel.blockfp.make_pod_exchange`` on a fake world of 512
ranks (rank 0 of a ``fake`` process group, a (2, 16, 16) ("pod",
"data", "model") mesh) over fake gradient shards of a real
architecture's full parameter tree, records the collectives rank 0
issues (``launch.roofline.CollectiveRecorder``), and compares the
per-chip wire bytes and the exchange time at ``LINK_BW`` of f32, int8
and blockfp8: the collective term of the paper's bounded-alignment
insight applied to gradient sync.

    PYTHONPATH=src python -m repro_torch.tools.exchange_bench --arch gemma2-9b
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, Optional, Tuple

import torch

METHODS = ("f32", "int8", "blockfp8")


def exchange_bytes(cfg, mesh_shape: Tuple[int, ...] = (2, 16, 16),
                   out: Optional[str] = None) -> Dict:
    """The record of one run: ``n_params``, each method's per-chip wire
    bytes, seconds at ``LINK_BW`` and bytes by op, and the reductions
    against f32. Starts (and ends) a fake process group of the mesh's
    size unless one of that size is started."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import LINK_BW, CollectiveRecorder
    from repro_torch.models import registry
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.blockfp import make_pod_exchange

    api = registry.build(cfg)
    meta = api.init(0, "meta")
    n_pods = mesh_shape[0]
    results = {"arch": cfg.arch_id, "mesh": list(mesh_shape),
               "n_params": sum(math.prod(x.shape) for x in tree_leaves(meta))}
    with fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, ("pod", "data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            grads = tree_map(lambda x: torch.empty(
                (n_pods,) + tuple(x.shape), dtype=torch.float32), meta)
            for method in METHODS:
                fn, in_sh, _ = make_pod_exchange(mesh, grads, method)
                placed = shd.distribute(grads, in_sh)
                with CollectiveRecorder() as rec:
                    fn(placed)
                coll = rec.stats
                t = coll.total_bytes / LINK_BW
                results[method] = {"per_chip_wire_bytes": coll.total_bytes,
                                   "exchange_s_at_link_bw": t,
                                   "by_op": coll.by_op}
                print(f"{cfg.arch_id} exchange[{method}]: "
                      f"{coll.total_bytes / 1e6:.1f} MB/chip wire, "
                      f"{t * 1e3:.2f} ms at {LINK_BW / 1e9:.0f} GB/s",
                      flush=True)
    base = results["f32"]["per_chip_wire_bytes"]
    for m in ("int8", "blockfp8"):
        results[f"{m}_reduction"] = base / results[m]["per_chip_wire_bytes"]
        print(f"{m}: {results[f'{m}_reduction']:.2f}x less DCI traffic")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1, default=float)
    return results


def main(argv=None):
    from repro_torch.configs import get_config
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--out", default="results/torch/perf/exchange.json")
    args = ap.parse_args(argv)
    exchange_bytes(get_config(args.arch), (2, 16, 16), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
