"""The 8-rank side of ``tests/test_torch_multidevice.py``: gloo CPU ranks
driving the port's sharded train step, ``make_serve_fns``, checkpoint
restore across topologies and the trainer CLI, each case held to the
port's own run on plain tensors on one device (which
``tests/test_torch_train.py`` and the serving tests hold to the JAX
reference), and the block-FP pod exchange (``make_pod_exchange``),
whose outputs the test holds to the JAX reference's.

``run_all(out_path)`` spawns the ranks once; every rank runs every case
in the same order (a collective that one rank skips would hang the
others), and rank 0 writes ``{case: result}`` to ``out_path`` (pickle).
A case that raises records its traceback and the next case runs. The
ranks run torch on one intra-op thread each and meet through a file in
a temporary directory (no fixed TCP port, so parallel test workers do
not collide).

Run it alone: ``PYTHONPATH=src python tests/_torch_multidev.py OUT.pkl``.
"""
import dataclasses
import os
import pickle
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

WORLD = 8

# tests/test_multidevice.py's cases: (arch, mesh) where "single" is
# (2, 4) ("data", "model") and "multi" (2, 2, 2) ("pod", "data", "model")
LOWER = (("qwen2-0.5b", "single"), ("qwen2-0.5b", "multi"),
         ("gemma2-9b", "single"), ("mixtral-8x7b", "multi"),
         ("qwen3-moe-30b-a3b", "single"), ("rwkv6-1.6b", "single"),
         ("recurrentgemma-9b", "multi"), ("seamless-m4t-medium", "single"),
         ("internvl2-1b", "multi"), ("stablelm-12b", "multi"),
         ("glm4-9b", "single"))
# (arch, mesh, microbatches, steps)
RUN = (("qwen2-0.5b", "single", 1, 3), ("mixtral-8x7b", "multi", 1, 3),
       ("rwkv6-1.6b", "single", 1, 3), ("qwen2-0.5b", "single", 2, 1))
SERVE = (("qwen2-0.5b", "bf16", 16), ("recurrentgemma-9b", "bf16", 16),
         ("qwen2-0.5b", "fidelity_int8", 8),
         ("qwen2-0.5b", "fidelity_fp16_ipu", 4))
MESHES = {"single": ((2, 4), ("data", "model")),
          "mesh42": ((4, 2), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN_SHAPE = ("t", 32, 8, "train")


def _mesh(name):
    from repro_torch.launch.mesh import make_mesh
    shape, names = MESHES[name]
    return make_mesh(shape, names, "cpu")


def _leaves(tree):
    from repro_torch.optim.tree import tree_leaves
    return tree_leaves(tree)


def _diff(a, b):
    """(max |a - b|, max |b|) over two trees of plain tensors."""
    err = scale = 0.0
    for x, y in zip(_leaves(a), _leaves(b)):
        x, y = x.detach().float(), y.detach().float()
        err = max(err, float((x - y).abs().max()) if x.numel() else 0.0)
        scale = max(scale, float(y.abs().max()) if y.numel() else 0.0)
    return err, scale


def _placement_faults(sharded, shardings):
    """Leaves that are not DTensors at their rule's placements with the
    local shape the spec gives."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import sharding as shd
    faults = []
    flat = []
    shd.tree_map_with_path(lambda p, x: flat.append((p, x)), sharded)
    specs = []
    shd.tree_map_with_path(lambda p, s: specs.append(s), shardings)
    for (path, x), sh in zip(flat, specs):
        if not isinstance(x, DTensor):
            faults.append((path, "not a DTensor"))
            continue
        sizes = shd.axis_sizes(sh.mesh)
        want = []
        for dim, ax in zip(x.shape, sh.spec + (None,) * x.dim()):
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a] if a is not None else 1
            want.append(dim // n)
        if tuple(x.placements) != sh.placements or \
                tuple(x.to_local().shape) != tuple(want):
            faults.append((path, str(x.placements), str(sh.placements),
                           tuple(x.to_local().shape), tuple(want)))
    return faults


def _train_parts(arch, microbatches=1):
    from repro_torch.configs import reduced
    from repro_torch.launch.train import TrainConfig, init_state
    from repro_torch.models import registry
    cfg = reduced(arch)
    api = registry.build(cfg)
    return cfg, api, init_state(api, seed=0, device="cpu"), \
        TrainConfig(microbatches=microbatches)


def _batch(cfg, step):
    from repro_torch.configs import InputShape
    from repro_torch.data.pipeline import batch_for
    return batch_for(cfg, InputShape(*TRAIN_SHAPE), step, device="cpu")


def _steps(step_fn, state, cfg, n, first=0):
    losses = []
    for i in range(first, first + n):
        state, m = step_fn(state, _batch(cfg, i))
        losses.append(float(m["loss"]))
    return state, losses


def case_lower(rank, arch, mesh_name):
    """Place the state for (arch, mesh), check every leaf's placements
    against the rules, and take one step beside the plain one."""
    from repro_torch.launch.train import (make_train_step, shard_state,
                                          state_shardings)
    from repro_torch.parallel import sharding as shd
    cfg, api, state, tc = _train_parts(arch)
    mesh = _mesh(mesh_name)
    sharded = shard_state(state, mesh)
    faults = _placement_faults(sharded, state_shardings(state, mesh))
    t0 = time.perf_counter()
    new, losses = _steps(make_train_step(api, tc, mesh), sharded, cfg, 1)
    seconds = time.perf_counter() - t0
    faults += _placement_faults(new, state_shardings(state, mesh))
    full = shd.undistribute(new)
    out = {"faults": faults, "losses": losses, "seconds": seconds,
           "leaves": len(_leaves(state))}
    if rank == 0:
        ref, ref_losses = _steps(make_train_step(api, tc), state, cfg, 1)
        out["plain_losses"] = ref_losses
        out["param_err"], out["param_scale"] = _diff(full.params, ref.params)
    return out


def case_run(rank, arch, mesh_name, microbatches, n_steps):
    """``n_steps`` steps on the mesh beside as many plain steps; the
    input state stays as it was (the step is functional)."""
    from repro_torch.launch.train import make_train_step, shard_state
    from repro_torch.parallel import sharding as shd
    cfg, api, state, tc = _train_parts(arch, microbatches)
    mesh = _mesh(mesh_name)
    sharded = shard_state(state, mesh)
    before = shd.undistribute(sharded)
    new, losses = _steps(make_train_step(api, tc, mesh), sharded, cfg,
                         n_steps)
    full = shd.undistribute(new)
    kept, _ = _diff(shd.undistribute(sharded), before)
    out = {"losses": losses, "input_changed": kept}
    if rank == 0:
        ref, ref_losses = _steps(make_train_step(api, tc), state, cfg,
                                 n_steps)
        out["plain_losses"] = ref_losses
        out["param_err"], out["param_scale"] = _diff(full.params, ref.params)
        out["opt_err"], out["opt_scale"] = _diff(full.opt, ref.opt)
    return out


def case_elastic(rank, tmp):
    """Save on (2, 4), restore on (4, 2) through ``restore_latest(
    shardings=)`` and ``elastic_reshard``, then step; the sharded save
    writes the plain save's bytes."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import (make_train_step, shard_state,
                                          state_shardings)
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.fault_tolerance import elastic_reshard
    import torch.distributed as dist
    cfg, api, state, tc = _train_parts("qwen2-0.5b")
    mesh_a, mesh_b = _mesh("single"), _mesh("mesh42")
    d_sharded, d_plain, d_a = (os.path.join(tmp, n) for n in
                               ("sharded", "plain", "a"))
    CheckpointManager(d_sharded).save(0, shard_state(state, mesh_a))
    if rank == 0:
        CheckpointManager(d_plain).save(0, state)
    dist.barrier()
    same_bytes = {}
    for name in ("manifest.msgpack", "arrays.npz"):
        with open(os.path.join(d_sharded, f"step_{0:09d}", name), "rb") as f:
            a = f.read()
        with open(os.path.join(d_plain, f"step_{0:09d}", name), "rb") as f:
            b = f.read()
        same_bytes[name] = a == b
    if not same_bytes["arrays.npz"]:
        # zip members carry write times: compare the arrays' bytes
        with np.load(os.path.join(d_sharded, f"step_{0:09d}",
                                  "arrays.npz")) as x, \
                np.load(os.path.join(d_plain, f"step_{0:09d}",
                                     "arrays.npz")) as y:
            same_bytes["arrays"] = sorted(x.files) == sorted(y.files) and \
                all(x[k].tobytes() == y[k].tobytes() and
                    x[k].dtype == y[k].dtype for k in x.files)
    new_a, l_a = _steps(make_train_step(api, tc, mesh_a),
                        shard_state(state, mesh_a), cfg, 1)
    CheckpointManager(d_a).save(1, new_a)
    sh_b = state_shardings(state, mesh_b)
    step, st_b, _ = CheckpointManager(d_a).restore_latest(state, sh_b)
    faults = _placement_faults(st_b, sh_b)
    specs = shd.zip_map(lambda _, s: s.spec, state, sh_b)
    st_e = elastic_reshard(new_a, mesh_b, specs)
    faults += _placement_faults(st_e, sh_b)
    same_e, _ = _diff(shd.undistribute(st_e), shd.undistribute(st_b))
    new_b, l_b = _steps(make_train_step(api, tc, mesh_b), st_b, cfg, 1,
                        first=1)
    full = shd.undistribute(new_b)
    out = {"step": step, "faults": faults, "same_bytes": same_bytes,
           "elastic_vs_restore": same_e, "losses": l_a + l_b}
    if rank == 0:
        ref, ref_losses = _steps(make_train_step(api, tc), state, cfg, 2)
        out["plain_losses"] = ref_losses
        out["param_err"], out["param_scale"] = _diff(full.params, ref.params)
    return out


def _greedy(prefill, decode, params, prompts, caches, n):
    logits, st = prefill(params, {"tokens": prompts}, caches)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa
    rows = [full(logits)]
    tok = torch.argmax(rows[-1], -1).to(torch.int32)
    toks = [tok]
    pos = torch.full((prompts.shape[0],), prompts.shape[1], dtype=torch.int32)
    for _ in range(n - 1):
        logits, st = decode(params, {"token": tok[:, None], "pos": pos}, st)
        rows.append(full(logits))
        tok = torch.argmax(rows[-1], -1).to(torch.int32)
        toks.append(tok)
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(rows, 1)


def case_serve(rank, arch, policy, n_new):
    """``make_serve_fns`` on (2, 4): prefill 8 prompts, then greedy
    decode, beside ``api.prefill``/``api.decode_step`` on plain
    tensors; the kernels' plain versions run on local shards."""
    from repro_torch.configs import reduced
    from repro_torch.layers import mplinear
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.serving.engine import make_serve_fns
    cfg = dataclasses.replace(reduced(arch), precision_policy=policy)
    api = registry.build(cfg)
    params = api.init(0, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        0, min(cfg.vocab, 1000), (8, 16), dtype=np.int32))
    mesh = _mesh("single")
    prefill, decode, c_sh, p_sh = make_serve_fns(
        api, mesh, {"tokens": registry.Spec((8, 16), torch.int32)}, 64, 8)
    placed = shd.distribute(params, p_sh)
    with mplinear.count_weight_quant() as wq:
        toks, logits = _greedy(prefill, decode, placed, prompts,
                               api.init_cache(8, 64, "cpu"), n_new)
    out = {"tokens": toks.numpy(), "weight_quants": wq[0]}
    if rank == 0:
        with torch.no_grad(), mplinear.count_weight_quant() as wq0:
            ref, ref_logits = _greedy(api.prefill, api.decode_step, params,
                                      prompts, api.init_cache(8, 64, "cpu"),
                                      n_new)
        out["plain_tokens"] = ref.numpy()
        out["plain_weight_quants"] = wq0[0]
        out["logit_err"] = float((logits - ref_logits).abs().max())
        top2 = torch.topk(ref_logits, 2, dim=-1).values
        out["margins"] = (top2[..., 0] - top2[..., 1]).numpy()
    return out


def case_cli(rank, tmp):
    """``launch.train.run`` across the 8 ranks (a (1, 8) mesh) beside
    the same loop on plain tensors."""
    from repro_torch.configs import reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop,
                                                     FTConfig)
    run = train.run(train.parse_args([
        "--reduced", "--steps", "4", "--seq", "32", "--device", "cpu",
        "--ckpt-every", "2", "--ckpt-dir", os.path.join(tmp, "mesh")]))
    out = {"losses": run.losses, "step": run.step}
    if rank == 0:
        cfg = reduced("qwen2-0.5b")
        api = registry.build(cfg)
        tc = train.TrainConfig(adamw=train.AdamWConfig(lr=3e-4),
                               total_steps=4)
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=32,
                                           global_batch=8), device="cpu")
        loop = FaultTolerantLoop(train.make_train_step(api, tc), ds.batch,
                                 os.path.join(tmp, "plain"),
                                 FTConfig(checkpoint_every=2))
        state, _ = loop.run(train.init_state(api, device="cpu"), 0, 4,
                            device="cpu")
        out["plain_losses"] = [h["loss"] for h in loop.history]
        out["param_err"], out["param_scale"] = _diff(run.state.params,
                                                     state.params)
    return out


EXCHANGE_METHODS = ("f32", "int8", "blockfp8")
COMPRESS_METHODS = ("int8", "blockfp8")


def _exchange_result(rank, out, out_sh, by_op, total_bytes):
    """Each output leaf's global shape, spec, placements and local
    shape, the collectives rank 0 issued, and (rank 0) the gathered
    outputs."""
    from repro_torch.parallel import sharding as shd
    leaves = {}
    for name in out:
        x, sh = out[name]["w"], out_sh[name]["w"]
        leaves[name] = {"shape": tuple(x.shape), "spec": sh.spec,
                        "placements": tuple(x.placements),
                        "want_placements": sh.placements,
                        "local_shape": tuple(x.to_local().shape),
                        "dtype": str(x.dtype)}
    full = shd.undistribute(out)
    if rank == 0:
        for name in out:
            leaves[name]["values"] = full[name]["w"].numpy()
    return {"leaves": leaves, "by_op": by_op, "total_bytes": total_bytes}


def _exchange_grads():
    from _jax_reference import exchange_grads
    return {k: {"w": torch.from_numpy(v["w"])}
            for k, v in exchange_grads().items()}


def case_exchange(rank, method, spec_fn):
    """``make_pod_exchange`` on (2, 2, 2) over ``tests/test_blockfp.py``'s
    gradients (the same numpy arrays on every rank), with
    ``fsdp_spec_fn=spec_fn``."""
    from repro_torch.launch.roofline import CollectiveRecorder
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.blockfp import make_pod_exchange
    mesh = _mesh("multi")
    grads = _exchange_grads()
    fn, in_sh, out_sh = make_pod_exchange(mesh, grads, method, spec_fn)
    placed = shd.distribute(grads, in_sh)
    with CollectiveRecorder() as rec:
        out = fn(placed)
    return _exchange_result(rank, out, out_sh, dict(rec.stats.by_op),
                            rec.stats.total_bytes)


def case_compress(rank, method):
    """``compress_grads`` over the mesh's 'pod' group on the local shards
    of the default exchange's input placements, re-wrapped at its output
    placements; and its refusal of "f32"."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.roofline import CollectiveRecorder
    from repro_torch.optim.tree import tree_map
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.blockfp import compress_grads, make_pod_exchange
    mesh = _mesh("multi")
    grads = _exchange_grads()
    _, in_sh, out_sh = make_pod_exchange(mesh, grads, method)
    placed = shd.distribute(grads, in_sh)
    local = tree_map(lambda x: x.to_local(), placed)
    group = mesh.get_group("pod")
    with CollectiveRecorder() as rec:
        summed = compress_grads(local, group, method)

    def wrap(name):
        sh = out_sh[name]["w"]
        shape = torch.Size((1,) + tuple(grads[name]["w"].shape)[1:])
        return {"w": DTensor.from_local(
            summed[name]["w"], mesh, sh.placements, run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())}

    out = {name: wrap(name) for name in grads}
    res = _exchange_result(rank, out, out_sh, dict(rec.stats.by_op),
                           rec.stats.total_bytes)
    try:
        compress_grads(local, group, "f32")
    except ValueError as e:
        res["refuses"] = repr(e)
    return res


def _cases(tmp):
    for arch, mesh in LOWER:
        yield f"lower/{arch}/{mesh}", case_lower, (arch, mesh)
    for arch, mesh, mb, n in RUN:
        yield f"run/{arch}/{mesh}/mb{mb}", case_run, (arch, mesh, mb, n)
    yield "elastic", case_elastic, (os.path.join(tmp, "elastic"),)
    for arch, policy, n in SERVE:
        yield f"serve/{arch}/{policy}", case_serve, (arch, policy, n)
    yield "cli", case_cli, (os.path.join(tmp, "cli"),)
    from _jax_reference import exchange_spec
    for method in EXCHANGE_METHODS:
        yield f"exchange/{method}", case_exchange, (method, None)
        yield f"exchange/fsdp/{method}", case_exchange, (method,
                                                         exchange_spec)
    for method in COMPRESS_METHODS:
        yield f"compress/{method}", case_compress, (method,)


def _worker(rank, world, tmp, out_path):
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    import logging
    logging.getLogger("torch").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "rendezvous"), rank=rank, world_size=world)
    results = {}
    try:
        for name, fn, args in _cases(tmp):
            t0 = time.perf_counter()
            try:
                results[name] = fn(rank, *args)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
            results[name]["wall"] = time.perf_counter() - t0
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_all(out_path, timeout=600.0):
    """Spawn the ranks, wait for them (killing them past ``timeout``
    seconds) and return rank 0's results."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="torch_multidev_")
    ctx = mp.start_processes(_worker, args=(WORLD, tmp, out_path),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out_path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    t0 = time.time()
    res = run_all(sys.argv[1])
    for k, v in res.items():
        print(k, {a: b for a, b in v.items()
                  if a not in ("tokens", "plain_tokens", "margins")})
    print("seconds", time.time() - t0)
