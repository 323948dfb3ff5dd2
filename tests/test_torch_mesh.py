"""The port's meshes (`repro_torch.launch.mesh`) and the runtime's rules
over them (`launch.steps.make_runtime(mesh=...)`) against the JAX
package's, on the CPU: the port's `DeviceMesh`es live in a fake process
group (`tests/_fake_group.py`), the reference's rules come from its own
`make_runtime` on an `AbstractMesh` of the same shape (it reads only the
mesh's axis names and sizes)."""

import dataclasses

import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

from _fake_group import fake_world
from repro import configs as jconfigs
from repro.core.autotune import EXEC_DOMAINS
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# every global batch of configs/shapes.py, and some that divide one mesh
# axis, both, or neither
BATCHES = sorted({s.global_batch for s in tconfigs.SHAPES}
                 | {2, 3, 16, 24, 48, 64, 96, 100, 512, 1000})


@pytest.fixture
def meshes():
    with fake_world(512):
        yield {name: tmesh.make_mesh(shape, axes, "cpu")
               for name, (shape, axes) in MESHES.items()}


def abstract(name):
    return AbstractMesh(*MESHES[name])


def test_make_mesh_refuses_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    assert not dist.is_initialized()          # and initialised none


def test_make_mesh_refuses_too_few_ranks():
    with fake_world(4):
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            tmesh.make_production_mesh(device_type="cpu")
        assert tmesh.make_mesh((2, 2), ("data", "model"),
                               "cpu").mesh_dim_names == ("data", "model")


def test_production_meshes_are_the_references():
    with fake_world(512):
        for multi_pod, name in ((False, "16x16"), (True, "2x16x16")):
            m = tmesh.make_production_mesh(multi_pod=multi_pod,
                                           device_type="cpu")
            shape, axes = MESHES[name]
            assert m.mesh_dim_names == axes
            assert tuple(m.shape) == shape
            assert tuple(m.get_coordinate()) == (0,) * len(shape)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_axes_for_is_the_references(meshes, mesh_name, batch):
    assert tmesh.batch_axes_for(meshes[mesh_name], batch) == \
        jmesh.batch_axes_for(abstract(mesh_name), batch)


@pytest.mark.parametrize("extra", EXEC_DOMAINS["extra_rules"], ids=str)
@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("shape_name", [s.name for s in tconfigs.SHAPES])
def test_make_runtime_rules_are_the_references(meshes, shape_name, mode,
                                               extra):
    """On both meshes, for every shape: the reference's rules (decode's
    forced `tp` included); the mesh rides on the runtime, and every other
    field is the mesh-less runtime's."""
    tshape = tconfigs.shape_by_name(shape_name)
    jshape = jconfigs.shape_by_name(shape_name)
    arch = "qwen2-0.5b"
    for name, mesh in meshes.items():
        rt = tsteps.make_runtime(tconfigs.get_arch(arch), tshape, mesh=mesh,
                                 sharding_mode=mode,
                                 rule_updates=dict(extra))
        want = jsteps.make_runtime(abstract(name), jconfigs.get_arch(arch),
                                   jshape, sharding_mode=mode,
                                   rule_updates=dict(extra))
        assert rt.rules.asdict() == want.rules.asdict()
        assert rt.rules.rules == want.rules.rules      # order included
        if tshape.mode == "decode":
            assert rt.rules.get("embed") is None       # tp, even for fsdp
        assert rt.mesh is mesh
        plain = tsteps.make_runtime(tconfigs.get_arch(arch), tshape)
        assert dataclasses.replace(rt, mesh=None, rules=None) == plain


def test_make_runtime_without_a_mesh_is_unchanged():
    """Every existing caller passes no mesh: no mesh and no rules, and
    `Runtime.shard` returns its argument."""
    import torch

    for shape in tconfigs.SHAPES:
        rt = tsteps.make_runtime(tconfigs.get_arch("qwen2-0.5b"), shape)
        assert rt.mesh is None and rt.rules is None
        x = torch.ones(2, 3)
        assert rt.shard(x, "batch", None) is x
