"""The port's sharding (`repro_torch.distributed`, `launch.steps.
step_placements` / `place_params`) against the JAX package's, on the CPU.

The reference's shardings come from its own `build_step_bundle` on an
`AbstractMesh` of 16x16 or 2x16x16 (no devices needed); the port's
placements from a fake process group of 512 ranks in this process
(`tests/_fake_group.py`), where this process is rank 0.  For all ten
archs, both meshes, `fsdp` and `tp`, every applicable shape and the three
`extra_rules` of the autotune's domain, every leaf of the step's
arguments and results (params, optimizer state, batch, caches, outputs)
must have the reference's `PartitionSpec`, the placements it implies, and
rank 0's shard shape of the reference's `NamedSharding`, exactly.  The
port's decoder keeps one parameter dict a layer where the reference
stacks a group's repeats on a leading "layers" axis (always unsharded):
the reference's tree is carried into the port's layout by
`convert.to_port_layout`, the stacking dimension dropped."""

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from _fake_group import fake_world
from repro import configs as jconfigs
from repro.core.autotune import EXEC_DOMAINS
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import distributed as tsharding
from repro_torch.convert import to_port_layout
from repro_torch.distributed import Layout, placements_of, shard_shape
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWState

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
EXTRA_RULES = EXEC_DOMAINS["extra_rules"]


@pytest.fixture(scope="module")
def meshes():
    with fake_world(512):
        yield {"16x16": make_production_mesh(device_type="cpu"),
               "2x16x16": make_production_mesh(multi_pod=True,
                                               device_type="cpu"),
               "2x4": make_mesh((2, 4), ("data", "model"), "cpu")}


def abstract(name):
    return AbstractMesh(*MESHES[name])


# ----------------------------------------------------------- rules as data

@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data"), ()],
                         ids=str)
def test_rules_are_the_references_data(batch_axes):
    for make in ("tp_rules", "fsdp_rules"):
        got = getattr(tsharding, make)(batch_axes)
        want = getattr(jsharding, make)(batch_axes)
        assert got.rules == want.rules
        assert got.asdict() == want.asdict()
        for upd in ({"kv_seq": None}, {"mlstm_state": "model"},
                    {"embed": "data", "batch": ("pod", "data")}):
            assert got.replace(**upd).rules == want.replace(**upd).rules
        for name in ("batch", "embed", "kv_seq", "absent", None):
            assert got.get(name) == want.get(name)
        axes = ["batch", None, "heads", "embed", "vocab", "layers"]
        assert got.spec(axes) == tuple(want.spec(axes))
    assert tsharding.tp_rules().rules == jsharding.tp_rules().rules


# ----------------------------------------------- every leaf of every cell

def expected_placements(spec, names):
    """The placements a spec implies, restated: mesh dimension i shards
    the tensor dimension whose mesh axes name it, else replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in names:
        dims = [d for d, e in enumerate(spec)
                if e is not None and name in ((e,) if isinstance(e, str)
                                              else tuple(e))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def reference_leaves(shardings, shapes):
    """The reference's tree as (spec, rank-0 shard shape, global shape)
    per leaf."""
    import jax

    return jax.tree.map(
        lambda sh, sd: (tuple(sh.spec), tuple(sh.shard_shape(sd.shape)),
                        tuple(sd.shape)),
        shardings, shapes)


def unstack(leaf, r):
    spec, shard, shape = leaf
    assert spec[0] is None and shard[0] == shape[0]    # "layers": unsharded
    return spec[1:], shard[1:], shape[1:]


def params_leaves(cfg, shardings, shapes):
    return to_port_layout(cfg, reference_leaves(shardings, shapes), unstack)


def compare(got, want, mesh, path=""):
    """Walk the port's `Layout` tree and the reference's leaf tree
    together; the number of leaves compared."""
    if isinstance(got, Layout):
        spec, shard, shape = want
        assert got.shape == shape, path
        assert got.spec == spec, path
        assert got.placements == expected_placements(
            spec, mesh.mesh_dim_names), path
        assert shard_shape(got.shape, mesh, got.placements) == shard, path
        return 1
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        return sum(compare(got[k], want[k], mesh, f"{path}/{k}")
                   for k in got)
    assert isinstance(got, (list, tuple)) and len(got) == len(want), path
    return sum(compare(g, w, mesh, f"{path}/{i}")
               for i, (g, w) in enumerate(zip(got, want)))


def cache_leaves(tcfg, shardings, shapes):
    leaves = reference_leaves(shardings, shapes)
    if tcfg.is_encdec:
        return leaves
    # the reference's [layer of a group repeat][unit kind] -> one a layer
    return [c for unit in leaves for c in unit]


def compare_cell(arch, shape_name, mesh_name, mesh, mode, extra):
    tcfg, jcfg = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    tshape = tconfigs.shape_by_name(shape_name)
    updates = dict(extra) or None
    got = tsteps.step_placements(tcfg, tshape, mesh, sharding_mode=mode,
                                 rule_updates=updates)
    ref = jsteps.build_step_bundle(
        jcfg, jconfigs.shape_by_name(shape_name), abstract(mesh_name),
        sharding_mode=mode, rule_updates=updates)
    assert got.rules.rules == ref.rt.rules.rules
    ins, args, outs = ref.in_shardings, ref.args_shapes, ref.out_shardings
    params = params_leaves(tcfg, ins[0], args[0])
    n = compare(got.inputs[0], params, mesh, "params")
    if tshape.mode == "train":
        opt = AdamWState(
            step=reference_leaves(ins[1].step, args[1].step),
            mu=params_leaves(tcfg, ins[1].mu, args[1].mu),
            nu=params_leaves(tcfg, ins[1].nu, args[1].nu))
        n += compare(got.inputs[1], opt, mesh, "opt")
        n += compare(got.inputs[2], reference_leaves(ins[2], args[2]), mesh,
                     "batch")
        # the outputs: params and moments as the inputs, metrics
        # replicated (the reference's out_shardings carry no shapes)
        assert len(got.outputs) == len(outs) == 3
        n += compare(got.outputs[0], params_leaves(tcfg, outs[0], args[0]),
                     mesh, "out/params")
        n += compare(got.outputs[1], AdamWState(
            step=reference_leaves(outs[1].step, args[1].step),
            mu=params_leaves(tcfg, outs[1].mu, args[1].mu),
            nu=params_leaves(tcfg, outs[1].nu, args[1].nu)), mesh,
            "out/opt")
        n += compare(got.outputs[2], {
            k: (tuple(sh.spec), (), ()) for k, sh in outs[2].items()},
            mesh, "out/metrics")
    elif tshape.mode == "prefill":
        n += compare(got.inputs[1], reference_leaves(ins[1], args[1]), mesh,
                     "batch")
        B, V = tshape.global_batch, tsteps.build_model(tcfg).v_pad
        n += compare(got.outputs, (tuple(outs.spec),
                                   tuple(outs.shard_shape((B, V))), (B, V)),
                     mesh, "out/logits")
    else:
        cache = cache_leaves(tcfg, ins[1], args[1])
        n += compare(got.inputs[1], cache, mesh, "cache")
        n += compare(list(got.inputs[2:]), [
            reference_leaves(ins[2], args[2]),
            reference_leaves(ins[3], args[3])], mesh, "token, pos")
        B, V = tshape.global_batch, tsteps.build_model(tcfg).v_pad
        logits_sh, cache_out = outs
        n += compare(got.outputs[0], (
            tuple(logits_sh.spec), tuple(logits_sh.shard_shape((B, 1, V))),
            (B, 1, V)), mesh, "out/logits")
        n += compare(got.outputs[1], cache_leaves(tcfg, cache_out, args[1]),
                     mesh, "out/cache")
    return n


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_every_leaf_is_placed_as_the_reference(meshes, arch, mesh_name,
                                               mode):
    n = 0
    cells = 0
    for shape in tconfigs.SHAPES:
        if not tconfigs.cell_applicable(arch, shape)[0]:
            continue
        for extra in EXTRA_RULES:
            n += compare_cell(arch, shape.name, mesh_name, meshes[mesh_name],
                              mode, extra)
            cells += 1
    assert cells in (9, 12) and n > 100 * cells


def _leaves(tree):
    """A tree's leaves in order, a `Layout` or a tuple of placements being
    one leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-medium"])
def test_tree_placements_are_the_step_placements_of_the_params(meshes,
                                                                arch):
    """`tree_placements` (the reference's `tree_shardings`) over the
    model's `Spec` tree gives the placements `step_placements` gives its
    parameters."""
    mesh = meshes["2x16x16"]
    cfg = tconfigs.get_arch(arch)
    sp = tsteps.step_placements(cfg, tconfigs.shape_by_name("train_4k"),
                                mesh)
    got = tsharding.tree_placements(
        mesh, sp.rules, tsteps.build_model(cfg).param_specs())
    want = [lay.placements for lay in _leaves(sp.inputs[0])]
    assert _leaves(got) == want and len(want) > 20


def test_a_stacked_port_tree_keeps_the_layers_axis(meshes):
    """whisper-medium's layers are stacked in both packages: the layer
    axis is a dimension of its own, replicated."""
    sp = tsteps.step_placements(tconfigs.get_arch("whisper-medium"),
                                tconfigs.shape_by_name("prefill_32k"),
                                meshes["16x16"])
    wq = sp.inputs[0]["encoder"]["attn"]["wq"]
    assert wq.spec[0] is None and wq.shape[0] == 24
    assert shard_shape(wq.shape, meshes["16x16"], wq.placements) == \
        (24, 1024 // 16, 1024 // 16)


# --------------------------------------------------- what both sides refuse

def test_a_non_divisible_dimension_raises_on_both_sides(meshes):
    mesh = meshes["16x16"]
    for spec, shape in ((("model",), (15,)), ((None, "data"), (4, 40)),
                        ((("data", "model"),), (128,))):
        with pytest.raises(ValueError):
            NamedSharding(abstract("16x16"), P(*spec)).shard_shape(shape)
        with pytest.raises(ValueError, match="does not divide"):
            shard_shape(shape, mesh, placements_of(mesh, spec))
    # divisible: the same local shape on both sides
    spec, shape = (("data", "model"), None), (512, 3)
    assert shard_shape(shape, mesh, placements_of(mesh, spec)) == tuple(
        NamedSharding(abstract("16x16"), P(*spec)).shard_shape(shape))


@pytest.mark.parametrize("spec", [("model", "model"),
                                  (("data", "model"), "model"),
                                  ("data", ("model", "data"))], ids=str)
def test_a_duplicated_mesh_axis_raises_on_both_sides(meshes, spec):
    from jax._src.named_sharding import DuplicateSpecError

    with pytest.raises(DuplicateSpecError):
        NamedSharding(abstract("16x16"), P(*spec))
    with pytest.raises(ValueError, match="gives mesh axis"):
        placements_of(meshes["16x16"], spec)


def test_unplaceable_specs_raise(meshes):
    """An axis the mesh lacks raises on both sides; a tuple out of the
    mesh's order (JAX splits it minor-major) has no plain DTensor
    placement, so the port refuses it."""
    with pytest.raises(ValueError):
        NamedSharding(abstract("16x16"), P("pod"))
    with pytest.raises(ValueError, match="has no axis"):
        placements_of(meshes["16x16"], ("pod",))
    with pytest.raises(ValueError, match="mesh's order"):
        placements_of(meshes["2x16x16"], (("data", "pod"),))
    from torch.distributed.tensor import Shard

    assert placements_of(meshes["2x16x16"], (("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))


# ---------------------------------------------------- real values, rank 0

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "whisper-medium"])
@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_place_params_gives_rank_0_its_chunks(meshes, arch, mode):
    """Smoke-size parameters placed on a fake 2x4 mesh: every leaf's local
    tensor is rank 0's block of the global one, of `shard_shape`'s
    shape."""
    mesh = meshes["2x4"]
    cfg = tconfigs.get_smoke(arch)
    model = tsteps.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), Runtime())
    sp = tsteps.step_placements(cfg, tconfigs.shape_by_name("train_4k"),
                                mesh, sharding_mode=mode)
    placed = tsteps.place_params(params, mesh, sp.inputs[0])
    flat = torch.utils._pytree.tree_leaves
    layouts = []

    def collect(t):
        if isinstance(t, Layout):
            layouts.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                collect(v)
        else:
            for v in t:
                collect(v)

    collect(sp.inputs[0])
    leaves, dts = flat(params), flat(placed)
    assert len(leaves) == len(dts) == len(layouts)
    sharded = 0
    for x, dt, lay in zip(leaves, dts, layouts):
        local = dt.to_local()
        want_shape = shard_shape(lay.shape, mesh, lay.placements)
        assert tuple(local.shape) == want_shape
        block = x[tuple(slice(0, n) for n in want_shape)]
        assert torch.equal(local, block)
        assert tuple(dt.placements) == lay.placements
        sharded += want_shape != tuple(x.shape)
    assert sharded > len(leaves) // 3


def test_place_params_refuses_a_mismatched_tree(meshes):
    mesh = meshes["2x4"]
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    sp = tsteps.step_placements(cfg, tconfigs.shape_by_name("prefill_32k"),
                                mesh)
    params = tsteps.build_model(cfg).init(torch.Generator().manual_seed(0),
                                          Runtime())
    params["embed"] = params["embed"][:, :-1]
    with pytest.raises(ValueError, match="layout has"):
        tsteps.place_params(params, mesh, sp.inputs[0])


def test_shard_constraint_redistributes_a_dtensor(meshes):
    """`Runtime.shard` (the reference's `rt.shard`) moves a replicated
    DTensor to the rules' placements; a plain tensor, or a runtime with no
    mesh, passes through."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = meshes["2x4"]
    rules = tsharding.fsdp_rules(("data",))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    dt = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    rt = Runtime(mesh=mesh, rules=rules)
    out = rt.shard(dt, "batch", "ff")
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert torch.equal(out.to_local(), x[:4, :3])
    assert tuple(rt.shard(dt, "batch").placements) == (Shard(0),
                                                       Replicate())
    assert rt.shard(x, "batch") is x
    assert Runtime().shard(dt, "batch") is dt
    assert tsharding.shard_constraint(dt, None, "batch", mesh=mesh) is dt
    assert tsharding.shard_constraint(dt, rules, "batch") is dt
    np.testing.assert_array_equal(tsharding.shard_constraint(
        dt, rules, None, "ff", mesh=mesh).to_local().numpy(),
        x[:, :3].numpy())
