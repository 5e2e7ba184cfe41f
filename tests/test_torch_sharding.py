"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's (``repro.parallel.sharding``), in process, with no
spawned ranks: the rules are pure functions of a leaf's path, its shape
and the mesh's axis names and sizes, so both run on abstract meshes
(``jax.sharding.AbstractMesh``, the port's ``launch.mesh.AbstractMesh``).

For every architecture, at full shape (the port's init on the meta
device, the reference's ``jax.eval_shape``) and reduced, on (2, 4) and
(4, 2) ("data", "model"), (2, 2, 2) ("pod", "data", "model"), (16, 16)
and (2, 16, 16), leaf by leaf and for equality:

* ``param_pspec`` over the parameter tree (the same key paths on both
  sides);
* ``opt_shardings`` over AdamW's state (``.step``, ``.m[...]``,
  ``.v[...]``: the ``^\\[[01]\\]`` strip fires on neither);
* ``batch_pspec`` over ``input_specs`` batches (train, prefill and
  decode, at a batch that every data axis divides and at 8, which the
  larger meshes do not);
* ``cache_pspec`` over ``init_cache`` and, for encdec, its decode state
  ``(caches, enc_out)``;
* and each parameter's placements give the shard shape the reference's
  ``NamedSharding`` gives.

Also: the activation constraints' sentinels and divisibility drop
(``act_sharding.spec_for``), the ``REPRO_SP`` switch of ``batch_seq`` on
a DTensor of a one-rank gloo group, and the meshes' refusals.
"""
import functools
import os
import tempfile

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import InputShape as JInputShape
from repro.models import registry as jregistry
from repro.optim import adamw_init as jadamw_init
from repro.parallel import sharding as jsh
from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.launch import mesh as tmesh
from repro_torch.models import registry
from repro_torch.optim import adamw_init
from repro_torch.parallel import act_sharding as act
from repro_torch.parallel import sharding as tsh

from _torch_parity import ARCHS

MESHES = (((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
# batch sizes: every data axis divides 512; none of the larger meshes'
# data axes divides 8 on (16, 16) and (2, 16, 16)
BATCHES = (512, 8)
CACHE_LEN = 64


def _port_cfg(arch, size):
    return get_config(arch) if size == "full" else reduced(arch)


def _ref_cfg(arch, size):
    return jget_config(arch) if size == "full" else jreduced(arch)


@functools.lru_cache(maxsize=None)
def _trees(arch, size):
    """(port trees, reference trees): params, opt, caches per batch and
    batches per (kind, batch), shapes only."""
    cfg, jcfg = _port_cfg(arch, size), _ref_cfg(arch, size)
    api, japi = registry.build(cfg), jregistry.build(jcfg)
    params = api.init(0, "meta")
    jparams = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
    port = {"params": params, "opt": adamw_init(params)}
    ref = {"params": jparams, "opt": jax.eval_shape(jadamw_init, jparams)}
    for b in BATCHES:
        caches = api.init_cache(b, CACHE_LEN, "meta")
        jcaches = jax.eval_shape(lambda: japi.init_cache(b, CACHE_LEN))
        if cfg.family == "encdec":
            t = CACHE_LEN // 4
            caches = (caches, torch.empty((b, t, cfg.d_model),
                                          device="meta"))
            jcaches = (jcaches, jax.ShapeDtypeStruct((b, t, cfg.d_model),
                                                     jax.numpy.bfloat16))
        port[f"caches{b}"], ref[f"caches{b}"] = caches, jcaches
        for kind in ("train", "prefill", "decode"):
            specs = registry.input_specs(cfg, InputShape("s", 32, b, kind))
            port[f"{kind}{b}"] = {k: torch.empty(v.shape, device="meta")
                                  for k, v in specs.items()}
            ref[f"{kind}{b}"] = jregistry.input_specs(
                jcfg, JInputShape("s", 32, b, kind))
    return port, ref


def _padded(spec, nd):
    spec = tuple(spec)
    return spec + (None,) * (nd - len(spec))


def _port_specs(tree, rule, mesh):
    out = {}
    tsh.tree_map_with_path(
        lambda path, leaf: out.__setitem__(path, _padded(
            rule(path, leaf), leaf.dim())), tree)
    return out


def _ref_specs(tree, rule):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): _padded(rule(jax.tree_util.keystr(k),
                                                  leaf), len(leaf.shape))
            for k, leaf in flat}


def _named_specs(tree, shardings):
    """path -> spec of a ``NamedSharding`` tree laid over ``tree``."""
    out = {}
    paths = []
    tsh.tree_map_with_path(lambda p, x: paths.append((p, x.dim())), tree)
    found = []
    tsh.tree_map_with_path(lambda _, s: found.append(s), shardings)
    for (path, nd), s in zip(paths, found):
        out[path] = _padded(s.spec, nd)
    return out


@pytest.mark.parametrize("mesh_shape,names", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("size", ("full", "reduced"))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_the_reference(arch, size, mesh_shape, names):
    port, ref = _trees(arch, size)
    mesh = tmesh.abstract_mesh(mesh_shape, names)
    jmesh = AbstractMesh(mesh_shape, names)
    checked = 0

    def same(got, want, what):
        nonlocal checked
        assert set(got) == set(want), (what, set(got) ^ set(want))
        diff = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
        assert not diff, (what, diff)
        checked += len(want)

    # parameters: the rule, and the NamedSharding tree built from it
    want = _ref_specs(ref["params"], lambda p, x: jsh.param_pspec(
        p, x.shape, jmesh))
    same(_port_specs(port["params"], lambda p, x: tsh.param_pspec(
        p, tuple(x.shape), mesh), mesh), want, "params")
    same(_named_specs(port["params"], tsh.param_shardings(port["params"],
                                                         mesh)),
         want, "param_shardings")
    # optimizer state, as opt_shardings places it
    jopt = jsh.opt_shardings(ref["opt"], jmesh)
    flat_s = jax.tree_util.tree_leaves(jopt)
    flat, _ = jax.tree_util.tree_flatten_with_path(ref["opt"])
    want = {jax.tree_util.keystr(k): _padded(s.spec, len(x.shape))
            for (k, x), s in zip(flat, flat_s)}
    same(_named_specs(port["opt"], tsh.opt_shardings(port["opt"], mesh)),
         want, "opt")
    for b in BATCHES:
        for kind in ("train", "prefill", "decode"):
            same(_port_specs(port[f"{kind}{b}"], lambda p, x: tsh.batch_pspec(
                p, tuple(x.shape), mesh), mesh),
                _ref_specs(ref[f"{kind}{b}"], lambda p, x: jsh.batch_pspec(
                    p, x.shape, jmesh)), f"batch {kind} {b}")
        same(_named_specs(port[f"caches{b}"], tsh.cache_shardings(
            port[f"caches{b}"], mesh)),
            _ref_specs(ref[f"caches{b}"], lambda p, x: jsh.cache_pspec(
                p, x.shape, jmesh)), f"caches {b}")
    # placements -> shard shapes, against the reference's NamedSharding
    sizes = dict(zip(names, mesh_shape))
    flat, _ = jax.tree_util.tree_flatten_with_path(ref["params"])
    port_leaves = {}
    tsh.tree_map_with_path(lambda p, x: port_leaves.__setitem__(p, x),
                           port["params"])
    for k, leaf in flat:
        path = jax.tree_util.keystr(k)
        spec = tsh.param_pspec(path, tuple(leaf.shape), mesh)
        local = list(leaf.shape)
        for axis, pl in zip(names, tsh.placements(spec, mesh)):
            if pl.is_shard():
                local[pl.dim] //= sizes[axis]
        want = NamedSharding(jmesh, jsh.param_pspec(
            path, leaf.shape, jmesh)).shard_shape(leaf.shape)
        assert tuple(local) == tuple(want), (path, local, want)
        assert tuple(port_leaves[path].shape) == tuple(leaf.shape)
    assert checked > 0


def test_placements_take_axes_in_mesh_order():
    mesh = tmesh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    pl = tsh.placements((None, ("pod", "data"), "model"), mesh)
    assert [(p.is_shard(), getattr(p, "dim", None)) for p in pl] == [
        (True, 1), (True, 1), (True, 2)]
    assert all(p.is_replicate() for p in tsh.placements((), mesh))
    with pytest.raises(ValueError, match="order"):
        tsh.placements((("data", "pod"),), mesh)


class _Fake:
    """What ``act_sharding.spec_for`` reads of a DTensor."""

    def __init__(self, shape, mesh):
        self.shape, self.device_mesh = tuple(shape), mesh

    def dim(self):
        return len(self.shape)


def test_activation_specs_resolve_sentinels_and_drop_what_does_not_divide():
    m24 = tmesh.abstract_mesh((2, 4), ("data", "model"))
    m222 = tmesh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert act.spec_for(_Fake((8, 32, 64), m24), act.DP, act.MDL) == (
        "data", "model", None)
    assert act.spec_for(_Fake((8, 32, 64), m222), act.DP, act.MDL) == (
        ("pod", "data"), "model", None)
    # 14 heads on a 4-way model axis and a batch of 3: both dropped
    assert act.spec_for(_Fake((3, 5, 14, 64), m24), act.DP, None, act.MDL,
                        None) == (None, None, None, None)
    assert act.spec_for(_Fake((8, 6), m24), act.DP, act.MDL) == (
        "data", None)


@pytest.fixture
def one_rank_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "rendezvous"), rank=0, world_size=1)
        try:
            yield tmesh.make_single_device_mesh("cpu")
        finally:
            dist.destroy_process_group()


def test_batch_seq_shards_the_sequence_unless_repro_sp_is_0(
        one_rank_group, monkeypatch):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = one_rank_group
    x = distribute_tensor(torch.randn(4, 6, 8), mesh,
                          [Replicate(), Replicate()])
    monkeypatch.delenv("REPRO_SP", raising=False)
    assert tuple(act.batch_seq(x).placements) == (Shard(0), Shard(1))
    monkeypatch.setenv("REPRO_SP", "0")
    assert tuple(act.batch_seq(x).placements) == (Shard(0), Replicate())
    # a plain tensor passes through untouched
    y = torch.ones(2, 3)
    assert act.batch_seq(y) is y
    # a shape the world cannot give, and a CUDA mesh over gloo, raise
    with pytest.raises(ValueError, match="world size is 1"):
        tmesh.make_test_mesh(device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            tmesh.make_single_device_mesh("cuda")


def test_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="length"):
        tmesh.abstract_mesh((2, 4), ("data",))
