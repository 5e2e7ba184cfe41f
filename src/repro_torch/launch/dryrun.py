"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake
world (mirror of ``repro/launch/dryrun.py``; no card needed).

The reference forces 512 XLA host devices, lowers and compiles each
cell, and reads XLA's memory and cost analysis and the compiled HLO.
The port does the same work without allocating anything. For each cell
it

  1. starts a fake process group of the mesh's size
     (``torch.testing._internal.distributed.fake_pg``: rank 0 of 256 or
     512, its collectives return at once) unless one of that size is
     started, and builds the production mesh on it (16x16 single-pod,
     2x16x16 multi-pod; ``launch.mesh``, ``device="cpu"``);
  2. builds the state and the batch as fake tensors
     (``FakeTensorMode``: shapes and dtypes, no storage), placed by the
     sharding rules as DTensors;
  3. runs the port's own program on them once, as every rank would run
     it: train ``make_train_step(api, TrainConfig(compression,
     microbatches), mesh)``, prefill ``api.prefill`` and decode
     ``api.decode_step`` on params, caches and batch placed by
     ``param_shardings``, ``cache_shardings`` and ``batch_shardings``;
  4. records what rank 0 ran, on its local tensors:
     * FLOPs, by the formulas of ``torch.utils.flop_counter`` (its
       ``flop_registry``) on each op's local operands.
       ``FlopCounterMode`` itself would count an op on DTensors at
       their global shapes;
     * bytes: every op's operand and result bytes (views and
       allocations aside), an unfused upper bound, as XLA-CPU's
       "bytes accessed" is;
     * collectives: ``launch.roofline.CollectiveRecorder``;
     * per-device memory: the peak of
       ``torch.distributed._tools.mem_tracker.MemTracker``, with the
       state's local shards registered as parameters and optimizer
       state;
     and writes a JSON record with the reference's keys (``memory``
     holds the tracker's categories at the peak in place of XLA's
     argument, temp and output sizes, and ``fits_card`` replaces
     ``fits_16gb``: the per-device peak against ``card_bytes``, the
     card's memory where CUDA is present, else the H100 SXM data
     sheet's 80 GB). ``lower_s`` is the set-up (state, placements),
     ``compile_s`` the traced run.

The default policy (``bf16``) launches none of the hand-written
kernels, so tracing on fake CPU tensors counts the ops the card would
run on that path. A cell that cannot be traced is recorded with
``status: "error"`` and its traceback, never skipped.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single [--out results/torch/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch import roofline as rl

# the H100 SXM data sheet's HBM3 capacity, where no card is present
H100_BYTES = 80e9


def card_bytes() -> float:
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return H100_BYTES


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks (this process rank 0)
    while open; one already started of that size is used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    elif dist.get_world_size() != world:
        raise RuntimeError(f"a {world}-rank dry-run needs a fake world of "
                           f"{world}; the process group has "
                           f"{dist.get_world_size()}")
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


# ops that move no data (views alias their input; allocations and
# metadata queries read nothing)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "detach", "alias",
               "lift_fresh", "_local_scalar_dense", "set_", "resize_"}


class CostCounter(rl.CollectiveRecorder):
    """FLOPs, bytes and collectives of the ops rank 0 runs on local
    tensors while open (see the module docstring). What it does with an
    op depends on the op alone, so that is worked out once an op."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self._plans = {}

    def _plan(self, func):
        """(try its decomposition, FLOP formula or None, counts bytes,
        is a collective) of an op."""
        plan = self._plans.get(func)
        if plan is None:
            packet = func._overloadpacket
            flop = self.registry.get(packet)
            aten = func.namespace == "aten"
            plan = (flop is None and aten, flop,
                    aten and not func.is_view
                    and func._opname not in _NO_TRAFFIC,
                    rl._op_name(func) in rl.COLLECTIVES)
            self._plans[func] = plan
        return plan

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        decompose, flop, traffic, collective = self._plan(func)
        if decompose:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            # no decomposition: never try this op again
            self._plans[func] = (False, flop, traffic, collective)
        out = func(*args, **kwargs)
        if not (flop or traffic or collective) or not self._is_program_op():
            return out
        if collective:
            self.record(func, args, kwargs, out)
        if flop is not None:
            self.flops += int(flop(*args, **kwargs, out_val=out))
        if traffic:
            self.bytes += rl._nbytes(args) \
                + rl._nbytes(tuple(kwargs.values())) + rl._nbytes(out)
        return out


def _fake_tree(tree):
    """Meta tensors -> fake CPU tensors of the same shapes and dtypes
    (call under the ``FakeTensorMode``)."""
    from repro_torch.optim.tree import tree_map
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype), tree)


def _locals(tree):
    from repro_torch.optim.tree import tree_leaves
    return [x.to_local() if hasattr(x, "to_local") else x
            for x in tree_leaves(tree)]


def _register(tracker, tensors, reftype):
    for t in tensors:
        tracker._update_and_maybe_create_winfos(t, reftype)


def _build_cell(api, cfg, shape, mesh, compression, microbatches):
    """``(run, state_tensors, other_tensors)``: the cell's program as a
    no-argument call on placed fake tensors, its state's local shards
    as ``{reftype name: [tensors]}``, and the rest of its inputs."""
    from repro_torch.launch.train import (TrainConfig, init_state,
                                          make_train_step, shard_state)
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    specs = registry.input_specs(cfg, shape)
    batch = {k: torch.zeros(s.shape, dtype=s.dtype)
             for k, s in specs.items()}
    if shape.kind == "train":
        tc = TrainConfig(compression=compression, microbatches=microbatches)
        step = make_train_step(api, tc, mesh)
        state = shard_state(init_state(api, _fake_tree(api.init(0, "meta"))),
                            mesh)
        batch = shd.distribute(batch, shd.batch_shardings(batch, mesh))
        return (lambda: step(state, batch),
                {"PARAM": _locals(state.params), "OPT": _locals(state.opt)
                 + _locals((state.loss_scale, state.step))},
                _locals(batch))
    meta = api.init(0, "meta")
    params = shd.distribute(_fake_tree(meta),
                            shd.param_shardings(meta, mesh))
    cache = _fake_tree(api.init_cache(shape.global_batch, shape.seq_len,
                                      "meta"))
    if shape.kind == "decode" and cfg.family == "encdec":
        cache = (cache, torch.empty(
            (shape.global_batch, shape.seq_len // 4, cfg.d_model),
            dtype=torch.bfloat16))
    cache = shd.distribute(cache, shd.cache_shardings(cache, mesh))
    batch = shd.distribute(batch, shd.batch_shardings(batch, mesh))
    fn = api.prefill if shape.kind == "prefill" else api.decode_step

    def run():
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        with torch.no_grad(), implicit_replication():
            return fn(params, batch, cache)

    return run, {"PARAM": _locals(params)}, _locals((batch, cache))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             compression: str = "none", remat: str = "full",
             microbatches: int = 1, moe_dispatch: Optional[str] = None,
             cfg=None, shape=None,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict:
    """The dry-run record of one cell. ``cfg``, ``shape`` and
    ``mesh_shape`` override the production config, ``SHAPES[shape_name]``
    and the production mesh (the tests' reduced cells)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import (MemTracker,
                                                      _MemRefType)
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry

    cfg = cfg or get_config(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    if moe_dispatch and cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    mesh_name = "pod" + "x".join(str(s) for s in mesh_shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "skipped"}
    if not shape_applicable(cfg, shape):
        rec["reason"] = "long_500k needs sub-quadratic attention"
        return rec

    chips = math.prod(mesh_shape)
    api = registry.build(cfg)
    with fake_world(chips):
        mesh = make_mesh(mesh_shape, names, "cpu")
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            run, state, other = _build_cell(api, cfg, shape, mesh,
                                            compression, microbatches)
            t_lower = time.time() - t0
            tracker = MemTracker()
            _register(tracker, state["PARAM"], _MemRefType.PARAM)
            _register(tracker, state.get("OPT", ()), _MemRefType.OPT)
            tracker.track_external(*other)
            counter = CostCounter()
            with tracker, counter:
                out = run()
            del out
            t_run = time.time() - t0 - t_lower
    peak = tracker.get_tracker_snapshot("peak")
    dev_peak = next(iter(peak.values()), {}) if peak else {}
    memory = {getattr(k, "value", str(k)): int(v)
              for k, v in dev_peak.items()}
    coll = counter.stats
    terms = rl.terms_from_counts(arch, shape, mesh_name, chips,
                                 counter.flops, counter.bytes, coll, cfg)
    per_dev = int(memory.get("Total", 0))
    rec.update({
        "status": "ok",
        "chips": chips,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_run, 2),
        "memory": memory,
        "cost": {"flops": float(counter.flops),
                 "bytes accessed": float(counter.bytes)},
        "collectives": {"per_chip_link_bytes": coll.total_bytes,
                        "count": coll.count, "by_op": coll.by_op},
        "roofline": terms.to_dict(),
        "params": cfg.params_count(),
        "active_params": cfg.active_params_count(),
        "per_device_bytes": per_dev,
        "card_bytes": card_bytes(),
    })
    rec["fits_card"] = bool(per_dev < rec["card_bytes"])
    return rec


def cell_tag(arch, shape, multi, compression="none", remat="full", mb=1,
             md=None) -> str:
    tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
    if compression != "none":
        tag += f"__{compression}"
    if remat != "full":
        tag += f"__remat-{remat}"
    if mb > 1:
        tag += f"__mb{mb}"
    if md:
        tag += f"__{md}"
    return tag


def main(argv=None):
    from repro_torch.configs import ARCH_IDS, SHAPES
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moe-dispatch", default=None)
    ap.add_argument("--recommended", action="store_true",
                    help="apply the per-cell production config "
                         "(launch/cell_configs.py) instead of the "
                         "paper-faithful baseline settings")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mb, md = args.microbatches, args.moe_dispatch
                if args.recommended:
                    from repro_torch.launch.cell_configs import recommended
                    cc = recommended(arch, shape)
                    mb = max(mb, cc.microbatches)
                    md = md or cc.moe_dispatch
                tag = cell_tag(arch, shape, multi, args.compression,
                               args.remat, mb, md)
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = run_cell(arch, shape, multi,
                                   compression=args.compression,
                                   remat=args.remat, microbatches=mb,
                                   moe_dispatch=md)
                except Exception as e:  # noqa: BLE001 -- recorded
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" GB/dev={rec['per_device_bytes'] / 1e9:.2f}"
                             f" trace={rec['compile_s']:.0f}s")
                elif status == "error":
                    extra = " " + rec["error"][:120]
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
