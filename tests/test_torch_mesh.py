"""The port's meshes: ``launch.mesh`` (the reference's
``make_production_mesh`` and ``make_debug_mesh``) and the named-coordinate
lookup of ``distributed.sharding.Mesh``, on the CPU."""

import re

import numpy as np
import pytest
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as launch_mesh


def test_make_debug_mesh_defaults_to_one_device():
    m = launch_mesh.make_debug_mesh()
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 1, "model": 1}
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert m.device_at().type == want


@pytest.mark.parametrize("shape,axes", [
    ((2, 4), ("data", "model")), ((1, 4), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))])
def test_make_debug_mesh_names_one_device_everywhere(shape, axes):
    m = launch_mesh.make_debug_mesh(shape, axes, device="cpu")
    assert m.devices.shape == shape and m.axis_names == axes
    assert m.shape == dict(zip(axes, shape))
    assert {str(d) for d in m.devices.reshape(-1)} == {"cpu"}


def test_make_debug_mesh_needs_the_devices():
    if torch.cuda.device_count() >= 8:
        pytest.skip("this machine has 8 cards: the mesh fits")
    with pytest.raises(ValueError, match=r"needs 8 devices"):
        launch_mesh.make_debug_mesh((2, 4))


@pytest.mark.parametrize("multi_pod,shape", [(False, (16, 16)),
                                             (True, (2, 16, 16))])
def test_make_production_mesh_raises_without_the_cards(multi_pod, shape):
    n = int(np.prod(shape))
    if torch.cuda.device_count() >= n:
        pytest.skip(f"this machine has {n} cards")
    with pytest.raises(RuntimeError,
                       match=re.escape(f"mesh {shape} needs {n} devices, "
                                       f"found {torch.cuda.device_count()} "
                                       f"(cards: ")):
        launch_mesh.make_production_mesh(multi_pod=multi_pod)


def test_mesh_device_at_named_coordinates():
    grid = np.array([[[f"cpu:{p * 8 + d * 4 + m}" for m in range(4)]
                      for d in range(2)] for p in range(2)], dtype=object)
    m = sh.Mesh(grid, ("pod", "data", "model"))
    assert m.device_at(pod=1, data=0, model=3) == torch.device("cpu:11")
    assert m.device_at(model=2) == torch.device("cpu:2")      # others 0
    assert m.device_at(data=1, model=1) == torch.device("cpu:5")
    assert m.device_at() == torch.device("cpu:0")
    with pytest.raises(KeyError, match="shard"):
        m.device_at(shard=0)
    with pytest.raises(IndexError):
        m.device_at(model=4)
    part = sh.Mesh(grid[0], (sh.PARTITION_AXIS, sh.COL_AXIS))
    assert part.device(1, 2) == part.device_at(shard=1, col=2) == \
        torch.device("cpu:6")


def test_use_mesh_binds_any_mesh_and_partition_mesh_reuses_only_its_own():
    ep = launch_mesh.make_debug_mesh((2, 4), device="cpu")
    with sh.use_mesh(ep):
        assert sh.active_mesh() is ep
        # no PARTITION_AXIS: never reused for a partitioned plan
        mesh, _ = sh.partition_mesh(2)
        assert mesh is not ep
    assert sh.active_mesh() is None


def test_mesh_check_operands_refuses_another_device_type():
    m = launch_mesh.make_debug_mesh((1, 2), device="cuda")
    with pytest.raises(ValueError, match="devices of the operands' type"):
        m.check_operands(torch.zeros(2))
    launch_mesh.make_debug_mesh((1, 2), device="cpu").check_operands(
        torch.zeros(2))
