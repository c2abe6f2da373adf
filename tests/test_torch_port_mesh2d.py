"""The port's 2-D mesh, ``parallel`` block, TP rule table, layouts, wrap
refusals, run_meta block and reshaper against the JAX package's, in
process (no process group).

- the axis registry, ``mesh_from``'s tilings and refusals, and
  ``$TPUDDP_MODEL_SIZE``, case for case with ``tests/test_mesh2d.py``;
- ``tp_rules_hash`` equal to the JAX value; the specs, the local template
  and the per-chip bytes equal to ``tpuddp/parallel/tensor.py``'s;
- ``to_tp_tree``/``from_tp_tree`` and each rank's local shard
  (``tensor.local_state_dict``, ``convert.tp_local_from_jax*``) bitwise
  against the JAX TP layout's slices, and a shard's JAX leaf sizes equal to
  the JAX local template's (the comm plan's);
- ``validate_tp_geometry`` and the DDP wrap's refusal surface with the JAX
  texts (``tests/test_mesh2d.py:586-625``), the more-than-one-host refusal;
- ``tpuddp_torch/training/reshard.py`` against ``tpuddp/training/reshard.py``
  on the same JAX files: arrays and records equal, every refusal;
- the run_meta ``mesh`` block.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import config as jax_cfg
from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.observability import schema as jax_schema
from tpuddp.parallel import tensor as jax_tp
from tpuddp.parallel.comm import redistribute_residual as jax_redistribute
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel.mesh2d import AXIS_ROLES as JAX_AXIS_ROLES
from tpuddp.parallel.mesh2d import mesh2d as jax_mesh2d
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training import reshard as jax_rs

from tpuddp_torch import config as cfg
from tpuddp_torch import optim
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import (
    jax_from_state_dict, jax_sizes, jax_tp_from_tp_locals, jax_from_tp_locals, keystr,
    state_dict_from_jax, tp_local_from_jax, tp_local_from_jax_tp, tree_leaves,
)
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.observability import schema
from tpuddp_torch.parallel import backend, mesh2d, tensor
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import reshard as rs

NAME, V, T = "transformer_tiny", 64, 16
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    p, _ = jax_load_model(NAME, num_classes=V).init(KEY, jnp.zeros((1, T), jnp.int32))
    return _np(p)


# ------------------------------------------------------------ registry, block --

def test_axis_registry_is_the_jax_packages():
    assert dict(mesh2d.AXIS_ROLES) == dict(JAX_AXIS_ROLES)
    assert mesh2d.validate_axis("model") == "model"
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh2d.validate_axis("pipeline")


def test_mesh_object_places_the_rank_model_minor():
    m = mesh2d.Mesh2D(2, 2, rank=3)
    assert (m.data_index, m.model_index) == (1, 1) and m.shape == (2, 2)
    assert mesh2d.model_size(m) == 2 and mesh2d.data_size(m) == 2
    assert mesh2d.describe(m) == {"data": 2, "model": 2}
    assert mesh2d.is_tensor_parallel(m) and not mesh2d.is_tensor_parallel(None)
    assert mesh2d.squeeze_model(mesh2d.Mesh2D(4, 1, rank=0)) is None
    with pytest.raises(ValueError, match="cannot squeeze"):
        mesh2d.squeeze_model(m)
    with pytest.raises(ValueError, match="exactly"):
        mesh2d.mesh2d(3, 2)  # one process: a world of 1


@pytest.mark.parametrize("block", [None, {"model": 2}, {"data": 2, "model": 2}, {"data": "auto"}])
def test_resolve_parallel_is_the_jax_packages(monkeypatch, block):
    monkeypatch.delenv("TPUDDP_MODEL_SIZE", raising=False)
    assert cfg.resolve_parallel(block) == jax_cfg.resolve_parallel(block)
    monkeypatch.setenv("TPUDDP_MODEL_SIZE", "4")
    assert cfg.resolve_parallel(block) == jax_cfg.resolve_parallel(block) == {"data": "auto",
                                                                               "model": 4}


@pytest.mark.parametrize("block,message", [
    ({"data": 2, "modle": 2}, "unknown parallel key"),
    ({"model": 0}, "parallel.model must be >= 1"),
    ({"data": 0}, "parallel.data must be >= 1"),
    ("model=2", "must be a mapping"),
])
def test_malformed_parallel_blocks_are_the_jax_value_errors(monkeypatch, block, message):
    monkeypatch.delenv("TPUDDP_MODEL_SIZE", raising=False)
    for fn in (cfg.resolve_parallel, jax_cfg.resolve_parallel):
        with pytest.raises(ValueError, match=message):
            fn(block)


@pytest.mark.parametrize("block,world,topology", [
    ({"data": 3, "model": 2}, 4, "flat"),
    ({"model": 3}, 4, "flat"),
    ({"model": 2}, 4, "hierarchical"),
    ({"data": 2}, 4, "flat"),
])
def test_mesh_from_refusals_are_the_jax_texts(monkeypatch, block, world, topology):
    monkeypatch.delenv("TPUDDP_MODEL_SIZE", raising=False)
    with pytest.raises(ValueError) as jax_err:
        jax_cfg.mesh_from(block, world_size=world, comm_topology=topology)
    with pytest.raises(ValueError) as err:
        cfg.mesh_from(cfg.resolve_parallel(block), world, topology)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("block,world,data", [
    (None, 4, 4), ({"model": 2}, 4, 2), ({"data": 1, "model": 2}, 2, 1), ({"model": 4}, 8, 2),
])
def test_check_tiling_derives_the_data_width(monkeypatch, block, world, data):
    monkeypatch.delenv("TPUDDP_MODEL_SIZE", raising=False)
    assert cfg.check_tiling(cfg.resolve_parallel(block), world) == data
    assert cfg.mesh_from(cfg.resolve_parallel({"model": 1}), world) is None  # the flat world


# --------------------------------------------------------- the rule table --

def test_tp_rules_and_their_hash_are_the_jax_packages():
    assert tensor.tp_rules() == jax_tp.tp_rules()
    assert tensor.tp_rules_hash() == jax_tp.tp_rules_hash() == "30f351d190ef2cff"
    from tpuddp_torch.models.transformer import PARTITION_RULES

    assert tensor.tp_rules_hash(PARTITION_RULES) == jax_tp.tp_rules_hash(dict(PARTITION_RULES))


def test_specs_template_and_bytes_are_the_jax_packages(params):
    model = load_model(NAME, V)
    jax_model = jax_load_model(NAME, num_classes=V)
    tp_params = tensor.to_tp_tree(params)
    specs = tensor.tp_param_specs(model, tp_params)
    jax_specs = jax_tp.tp_param_specs(jax_model, jax_tp.to_tp_tree(params))
    mine = tensor._spec_leaves(specs)
    flat_specs = jax.tree_util.tree_flatten_with_path(
        jax_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    theirs = [(jax.tree_util.keystr(p), tuple(s) + (None,) * (np.ndim(leaf) - len(tuple(s))))
              for (p, s), leaf in zip(flat_specs, jax.tree_util.tree_leaves(tp_params))]
    assert mine == theirs
    for width in (2, 4):
        tpl = tensor.local_param_template(tp_params, specs, width)
        jax_tpl = jax_tp.local_param_template(tp_params, jax_specs, width)
        assert [(keystr(p), a.shape) for p, a in tree_leaves(tpl)] == [
            (jax.tree_util.keystr(p), a.shape) for p, a in jax.tree_util.tree_flatten_with_path(jax_tpl)[0]]
        assert tensor.per_chip_param_bytes(tp_params, specs, width) == \
            jax_tp.per_chip_param_bytes(tp_params, jax_specs, width)


def test_opt_state_specs_follow_the_parameter_paths(params):
    model = load_model(NAME, V)
    tp_params = tensor.to_tp_tree(params)
    specs = tensor.tp_param_specs(model, tp_params)
    state = {"m": tp_params, "step": np.zeros((), np.int32), "v": tp_params}
    out = tensor.opt_state_specs(state, specs)
    assert out["['m']['embed']['weight']"] == ("model", None)
    assert out["['v']['blocks'][1]['attn']['wqkv']"] == (None, None, "model")
    assert out["['step']"] == ()
    assert out["['m']['pos']['weight']"] == (None, None)  # same shape as embed, replicated


@pytest.mark.parametrize("width", [1, 2, 4])
def test_the_qkv_layout_round_trip_is_the_jax_packages(params, width):
    tp = tensor.to_tp_tree(params)
    jax_tp_tree = _np(jax_tp.to_tp_tree(params))
    for (pa, a), (_, b) in zip(tree_leaves(tp), tree_leaves(jax_tp_tree)):
        np.testing.assert_array_equal(a, b, err_msg=keystr(pa))
        assert a.shape == b.shape
    back = tensor.from_tp_tree(tp)
    for (pa, a), (_, b) in zip(tree_leaves(back), tree_leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=keystr(pa))


def _jax_local(tp_params, specs, index, width):
    """Model rank ``index``'s slice of the JAX TP-layout tree, as a
    ``shard_map`` body sees it."""
    def cut(path, leaf):
        spec = specs[keystr(path)]
        for axis, name in enumerate(spec):
            if name == "model":
                n = leaf.shape[axis] // width
                leaf = np.take(leaf, np.arange(index * n, (index + 1) * n), axis=axis)
        return leaf

    from tpuddp_torch.models.convert import tree_map

    return tree_map(cut, tp_params)


@pytest.mark.parametrize("width", [2, 4])
def test_each_ranks_shard_is_the_jax_tp_layouts_slice(params, width):
    """Every rank's torch shard, in the JAX layout, is bitwise its slice of
    the JAX TP tree (``wqkv (E, 3, HD)`` on its last axis, ...); the shards
    join back to the whole model and to the JAX TP tree."""
    model = load_model(NAME, V)
    tp_params = _np(jax_tp.to_tp_tree(params))
    specs = dict(tensor._spec_leaves(tensor.tp_param_specs(model, tp_params)))
    shards = []
    for index in range(width):
        local = tp_local_from_jax(params, index, width)
        np.testing.assert_equal(local, tp_local_from_jax_tp(tp_params, index, width))
        mine, _ = jax_from_state_dict(NAME, local)  # canonical form of the shard
        want = tensor.from_tp_tree(_jax_local(tp_params, specs, index, width))
        for (pa, a), (_, b) in zip(tree_leaves(mine), tree_leaves(want)):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {index} {keystr(pa)}")
        shards.append(local)
    for (pa, a), (_, b) in zip(tree_leaves(jax_from_tp_locals(shards)), tree_leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=keystr(pa))
    for (pa, a), (_, b) in zip(tree_leaves(jax_tp_from_tp_locals(shards)), tree_leaves(tp_params)):
        np.testing.assert_array_equal(a, b, err_msg=keystr(pa))
    whole = state_dict_from_jax(NAME, params)
    torch_shards = [tensor.local_state_dict(whole, i, width) for i in range(width)]
    for k, v in tensor.full_state_dict(torch_shards).items():
        assert torch.equal(v, whole[k]), k


@pytest.mark.parametrize("width", [2, 4])
def test_a_shards_leaf_sizes_are_the_jax_local_template(params, width):
    """The gradient comm plan's leaves: a shard module's JAX-order sizes
    are the JAX local template's (what its make_grad_comm buckets)."""
    full = load_model(NAME, V)
    shard = tensor.TensorParallelLM(full, mesh2d.Mesh2D(1, width, rank=width - 1))
    jax_model = jax_load_model(NAME, num_classes=V)
    tp_params = jax_tp.to_tp_tree(params)
    tpl = jax_tp.local_param_template(tp_params, jax_tp.tp_param_specs(jax_model, tp_params), width)
    assert jax_sizes("transformer", shard) == tuple(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tpl))
    assert shard.local_heads == full.n_heads // width and shard.vocab_size == V
    for name, t in shard.state_dict().items():
        want = tensor.local_state_dict(full.state_dict(), width - 1, width)[name]
        assert torch.equal(t, want), name


# ---------------------------------------------------------- the refusals --

def test_geometry_refusals_are_the_jax_texts():
    for port_model, jax_model, width in (
            (load_model(NAME, V), jax_load_model(NAME, num_classes=V), 3),
            (load_model(NAME, V), jax_load_model(NAME, num_classes=V), 8),
            (load_model("toy_mlp"), jax_load_model("toy_mlp"), 2)):
        with pytest.raises(ValueError) as jax_err:
            jax_tp.validate_tp_geometry(jax_model, width)
        with pytest.raises(ValueError) as err:
            tensor.validate_tp_geometry(port_model, width)
        assert str(err.value).replace("ToyMLP", "Sequential") == str(jax_err.value).replace(
            "ToyMLP", "Sequential")


def _port_wrap(model=None, opt=None, mesh=None, **kw):
    model = load_model(NAME, V) if model is None else model
    opt = optim.Adam(model.parameters(), lr=1e-2) if opt is None else opt
    return DistributedDataParallel(model, opt, CrossEntropyLoss(), device="cpu",
                                   mesh=mesh or mesh2d.Mesh2D(2, 2, rank=0), **kw)


CASES = {
    "mode": (dict(mode="auto"), "shard_map"),
    "wus": (dict(weight_update_sharding=True), "weight_update_sharding"),
    "hierarchical": (dict(comm_topology="hierarchical"), "hierarchical"),
    "accumulation": (dict(grad_accumulation=2), "grad_accumulation"),
    "clip": (dict(clip_grad_norm=1.0), "clip_grad_norm"),
    "remat": (dict(remat=True), "remat"),
    "augment": (dict(augment=lambda x: x), "augment"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_wraps_refusals_are_the_jax_texts(cpu_devices, case):
    """Case for case with tests/test_mesh2d.py:586-625, the JAX wrap's text
    each time (the JAX wrap takes its augment as a function of key and x)."""
    kw, match = CASES[case]
    jax_kw = dict(kw, augment=lambda key, x: x) if case == "augment" else kw
    with pytest.raises(ValueError, match=match) as jax_err:
        JaxDDP(jax_load_model(NAME, num_classes=V), jax_optim.Adam(lr=1e-2),
               jax_nn.CrossEntropyLoss(), mesh=jax_mesh2d(2, 2, devices=cpu_devices[:4]), **jax_kw)
    with pytest.raises(ValueError) as err:
        _port_wrap(**kw)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("which", ["lamb", "lars", "toy_mlp", "tiling"])
def test_optimizer_model_and_tiling_refusals_are_the_jax_texts(cpu_devices, which):
    model, jax_model = load_model(NAME, V), jax_load_model(NAME, num_classes=V)
    opt, jax_opt = optim.Adam(model.parameters(), lr=1e-2), jax_optim.Adam(lr=1e-2)
    mesh, jax_mesh = mesh2d.Mesh2D(2, 2, rank=0), jax_mesh2d(2, 2, devices=cpu_devices[:4])
    if which == "lamb":
        opt, jax_opt = optim.LAMB(model.parameters(), lr=1e-3), jax_optim.LAMB(1e-3)
    elif which == "lars":
        opt, jax_opt = optim.LARS(model.parameters(), lr=1.0), jax_optim.LARS(1.0)
    elif which == "toy_mlp":
        model, jax_model = load_model("toy_mlp"), jax_load_model("toy_mlp")
        opt = optim.Adam(model.parameters(), lr=1e-2)
    else:  # transformer_tiny has 4 heads: a model axis of 8 cannot tile it
        mesh, jax_mesh = mesh2d.Mesh2D(1, 8, rank=0), jax_mesh2d(1, 8, devices=cpu_devices[:8])
    with pytest.raises(ValueError) as jax_err:
        JaxDDP(jax_model, jax_opt, jax_nn.CrossEntropyLoss(), mesh=jax_mesh)
    with pytest.raises(ValueError) as err:
        _port_wrap(model, opt, mesh)
    assert str(err.value).replace("ToyMLP", "Sequential") == str(jax_err.value).replace(
        "ToyMLP", "Sequential")


def test_the_managed_entry_point_refuses_a_model_axis(monkeypatch, tmp_path):
    """The JAX managed entry point's ValueError (train_accelerate.py:986-994),
    raised before anything runs."""
    monkeypatch.delenv("TPUDDP_MODEL_SIZE", raising=False)
    monkeypatch.delenv("TPUDDP_WORLD_SIZE", raising=False)
    from tpuddp_torch import train_accelerate

    path = tmp_path / "s.yaml"
    path.write_text(json.dumps({"out_dir": str(tmp_path / "out"), "parallel": {"model": 2},
                                "local": {"device": "cpu", "gpu": {"num_gpus": 2}},
                                "training": {"model": NAME, "num_classes": V}}))
    with pytest.raises(ValueError, match="needs the explicit API") as err:
        train_accelerate.main(["--settings_file", str(path)])
    assert str(err.value) == (
        "parallel.model > 1 needs the explicit API (train_native.py / DistributedDataParallel); "
        "the managed Accelerator path runs pure data parallelism")


def test_more_than_one_host_is_refused(monkeypatch):
    monkeypatch.setattr(backend, "num_hosts", lambda: 2)
    with pytest.raises(ValueError, match="single-controller only"):
        _port_wrap()


def test_token_model_and_snapshot_refusals_stay():
    with pytest.raises(NotImplementedError, match="bf16 compute of token models"):
        cfg.training_config({"training": {"model": NAME, "compute_dtype": "bfloat16"}})
    from tpuddp_torch.training import loop

    class Wrap:
        model_size, rank, world_size, device = 2, 0, 4, torch.device("cpu")
        model = load_model(NAME, V)
        grad_accumulation = 1

    class Loader(list):
        batch_nbytes = 0

    with pytest.raises(NotImplementedError, match="tensor parallel, part 2"):
        loop.run_training_loop(Wrap(), Loader([1]), Loader([1]), None, snapshot=True,
                               log=lambda *a: None)


# ------------------------------------------------------------ the reshaper --

def test_the_format_marks_and_rules_mirror_the_jax_reshaper():
    for name in ("KEY_MARK", "BF16_MARK", "META_MARK", "TOPO_MARK", "CURSOR_MARK",
                 "FORMAT_VERSION", "TP_PLACEMENT_RULES"):
        assert getattr(rs, name) == getattr(jax_rs, name), name
    assert rs.FORMAT_VERSION == ckpt.FORMAT_VERSION


@pytest.mark.parametrize("old,new", [(2, 1), (2, 4), (4, 6), (3, 3)])
def test_redistribute_rows_is_the_jax_rule(old, new):
    mat = np.random.default_rng(old * 10 + new).standard_normal((old, 5)).astype(np.float32)
    got, action = rs.redistribute_rows(mat, new)
    want, jax_action = jax_redistribute(mat, new)
    assert action == jax_action
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory, cpu_devices, params):
    """JAX TP (2 x 2, bf16_ef) and DP (4, bf16_ef) checkpoints of
    transformer_tiny initialised from ``params``; the TP wrap under
    ``"tp_wrap"``."""
    root = tmp_path_factory.mktemp("tp_reshard")
    out = {}
    for label, (data, model) in (("tp", (2, 2)), ("dp", (4, 1))):
        ddp = JaxDDP(jax_load_model(NAME, num_classes=V), jax_optim.Adam(lr=1e-2),
                     jax_nn.CrossEntropyLoss(),
                     mesh=jax_mesh2d(data, model, devices=cpu_devices[:data * model]),
                     comm_hook="bf16_ef")
        st = ddp.init_state(KEY, jnp.zeros((1, T), jnp.int32), params=params, model_state=())
        out[label] = jax_ckpt.save_on_main(str(root / label), 0, st, world_size=data * model)
        out[f"{label}_wrap"] = (ddp, st)
    return out


def _load(path):
    with np.load(path) as f:
        return dict(f.items())


@pytest.mark.parametrize("src,data,model", [
    ("tp", 4, 1), ("tp", 1, 2), ("tp", 2, 1), ("tp", 4, 2), ("tp", 2, 2), ("dp", 2, 2),
    ("dp", 1, 4), ("dp", 2, 1),
])
def test_the_reshaper_is_the_jax_reshapers(jax_files, src, data, model):
    stored = _load(jax_files[src])
    got, topo, actions = rs.reshard_arrays(dict(stored), data, model)
    want, jax_topo, jax_actions = jax_rs.reshard_arrays(dict(stored), data, model)
    assert topo == jax_topo and actions == jax_actions
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reshard_checkpoint_writes_a_file_with_its_manifest(jax_files, tmp_path):
    dst = str(tmp_path / "ckpt_0.npz")
    report = rs.reshard_checkpoint(jax_files["tp"], dst, 4, 1)
    assert report["from"] == {"data": 2, "model": 2} and report["to"] == {"data": 4, "model": 1}
    assert ckpt.verify_file(dst, require_manifest=True)
    assert jax_ckpt.read_topology(dst)["model_size"] == 1


@pytest.mark.parametrize("case", ["v1", "data_flat", "width"])
def test_the_reshapers_refusals_are_the_jax_ones(jax_files, case):
    if case == "v1":
        stored, data, model = {".params['w']": np.ones((2, 2), np.float32)}, 2, 1
    elif case == "data_flat":
        topo = {"format": 4, "world_size": 4, "model_size": 1, "mesh_axes": ["data"],
                "mesh_shape": [4], "leaves": {".opt_state.m": {"kind": "data_flat"}}, "placement": {}}
        stored = {".params['w']": np.ones((2, 4), np.float32), ".opt_state.m": np.ones(8, np.float32),
                  rs.TOPO_MARK: np.asarray(json.dumps(topo))}
        data, model = 2, 2
    else:  # transformer_tiny's split dimensions do not divide by 3
        stored, data, model = _load(jax_files["tp"]), 1, 3
    with pytest.raises(jax_rs.ReshardError) as jax_err:
        jax_rs.reshard_arrays(dict(stored), data, model)
    with pytest.raises(rs.ReshardError) as err:
        rs.reshard_arrays(dict(stored), data, model)
    assert str(err.value) == str(jax_err.value)


# ------------------------------------------------------------- run_meta --

def test_the_run_meta_mesh_block(cpu_devices):
    h = tensor.tp_rules_hash()
    meta = schema.make_run_meta(world_size=4, comm_hook="none",
                                mesh={"data": 2, "model": 2, "tp_rules_hash": h})
    jax_meta = jax_schema.make_run_meta(mesh=jax_mesh2d(2, 2, devices=cpu_devices[:4]),
                                        comm_hook="none", tp_rules_hash=h)
    assert meta["mesh"] == jax_meta["mesh"] == {"data": 2, "model": 2, "tp_rules_hash": h}
    assert meta["mesh_shape"] == jax_meta["mesh_shape"] == {"data": 2, "model": 2}
    assert not schema.validate_record(meta)
    flat = schema.make_run_meta(world_size=4, comm_hook="none")
    assert flat["mesh"] == {"data": 4, "model": 1, "tp_rules_hash": None}
    assert flat["mesh_shape"] == {"data": 4}


def test_the_tp_wraps_construction_is_the_jax_wraps(params, jax_files):
    """A model-2 wrap built in process (no group is used before the first
    step): the shard replaces the model, the optimizer is rebound to its
    parameters with their JAX leaf indices, the comm plan and byte counts
    are the JAX TP wrap's over the local shard, the residual is one rank's
    slice of the JAX ``(world * per,)`` vector, and the overlap resolves
    off with the JAX reason."""
    from tpuddp_torch.models.convert import jax_leaf_index

    full = load_model(NAME, V)
    full.load_state_dict(state_dict_from_jax(NAME, params))
    leaf = jax_leaf_index(NAME, full)
    opt = optim.Adam(full.parameters(), lr=1e-2,
                     leaf_index=[leaf[n] for n, _ in full.named_parameters()])
    ddp = _port_wrap(full, opt, mesh2d.Mesh2D(2, 2, rank=3), comm_hook="bf16_ef")
    jax_ddp, st = jax_files["tp_wrap"]
    assert isinstance(ddp.model, tensor.TensorParallelLM) and ddp.model.mesh.model_index == 1
    shard = dict(ddp.model.named_parameters())
    assert [p for g in ddp.optimizer.param_groups for p in g["params"]] == list(shard.values())
    assert {n: ddp.optimizer.leaf_index[p] for n, p in shard.items()} == leaf
    assert (ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_per_step_f32) == (
        jax_ddp.grad_comm_bytes_per_step, jax_ddp.grad_comm_bytes_per_step_f32)
    assert ddp._comm.buckets == jax_ddp._comm.buckets and ddp.data_size == 2
    assert ddp.residual.shape == (st.comm_state.shape[0] // 4,)
    assert ddp.comm_overlap_meta == jax_ddp.comm_overlap_meta
    assert ddp.mesh_block == {"data": 2, "model": 2, "tp_rules_hash": jax_tp.tp_rules_hash()}
    assert ddp.tp_rules_hash == jax_ddp.tp_rules_hash
    want = tensor.local_state_dict(full.state_dict(), 1, 2)
    for name, t in ddp.model.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_a_tp_residual_at_another_data_width_is_the_jax_refusal(tmp_path):
    """A model-2 ``per_replica`` residual fitted to another data width
    without ``reshard_on_mismatch``: the JAX loader's TopologyMismatch, its
    text (``tpuddp/training/checkpoint.py:476-488``)."""
    topo = {"format": 4, "world_size": 4, "model_size": 2, "mesh_axes": ["data", "model"],
            "mesh_shape": [2, 2], "placement": {},
            "leaves": {".comm_state": {"kind": "per_replica", "world": 4, "per": 6, "model": 2}}}
    stored = np.arange(24, dtype=np.float32)
    path = str(tmp_path / "ckpt_0.npz")
    with pytest.raises(jax_ckpt.TopologyMismatch) as jax_err:
        jax_ckpt._fit_leaf(path, ".comm_state", stored, np.zeros(12, np.float32), topo, 2, [])
    with pytest.raises(ckpt.TopologyMismatch) as err:
        ckpt.fit_residual(path, stored, topo, 12, 2, [])
    assert str(err.value) == str(jax_err.value) and "reshard_on_mismatch" in str(err.value)
