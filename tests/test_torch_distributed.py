"""vlm_clip_tpu_torch.parallel against vlm_clip_tpu.parallel: the launch
decisions on env dicts (the reference's tests/test_distributed.py case
for case, on the PyTorch launcher's variables), rank gating, the logging
gate, ZeRO-1's sharding rule, and the device mesh at one rank on gloo.
The two-process data-parallel step is tests/test_torch_data_parallel.py.
"""

import logging
import socket

import pytest
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import jax
from jax.sharding import PartitionSpec as JP

from vlm_clip_tpu.parallel import distributed as RD
from vlm_clip_tpu.parallel.mesh import MeshConfig as RMeshConfig
from vlm_clip_tpu.parallel.mesh import create_mesh as r_create_mesh
from vlm_clip_tpu.parallel.sharding import zero1_specs as r_zero1_specs
from vlm_clip_tpu_torch.parallel import distributed as D
from vlm_clip_tpu_torch.parallel import mesh as M
from vlm_clip_tpu_torch.parallel.sharding import zero1_specs
from vlm_clip_tpu_torch.utils import logging as PL

LAUNCH = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
          "LOCAL_WORLD_SIZE")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCH:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_config_from_env_single_process():
    cfg = D.config_from_env({})
    assert not cfg.wanted and not RD.config_from_env({}).wanted
    cfg.validate()  # no-op
    assert D.maybe_initialize(cfg) is False


def test_config_from_env_multi():
    env = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234",
           "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "2"}
    cfg = D.config_from_env(env)
    want = RD.config_from_env({RD.ENV_COORDINATOR: "10.0.0.1:1234",
                               RD.ENV_NUM_PROCESSES: "4",
                               RD.ENV_PROCESS_ID: "2"})
    assert cfg.wanted and want.wanted
    cfg.validate()
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id) \
        == (want.coordinator_address, want.num_processes, want.process_id)
    assert (cfg.local_rank, cfg.local_world_size) == (0, 2)
    # a launch at one rank still brings a process group up
    assert D.config_from_env({"MASTER_ADDR": "h", "MASTER_PORT": "1",
                              "WORLD_SIZE": "1", "RANK": "0"}).wanted


@pytest.mark.parametrize("kw,match", [
    (dict(num_processes=4), "requires"),
    (dict(coordinator_address="h:1"), "missing"),
    (dict(coordinator_address="h:1", num_processes=2, process_id=5),
     "outside")])
def test_config_validation_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        RD.DistributedConfig(**kw).validate()
    with pytest.raises(ValueError, match=match):
        D.DistributedConfig(**kw).validate()


@pytest.mark.parametrize("args", [(32, 4, 4), (8, 1, 2), (16, 2, 1),
                                  (32, 4, 16), (30, 4, 1), (6, 2, 2)])
def test_hybrid_mesh_shape_matches_reference(args):
    """Nodes take the reference's slices' place: DP outermost across
    them, TP inside one."""
    try:
        want = RD.hybrid_mesh_shape(*args)
    except ValueError:
        with pytest.raises(ValueError):
            D.hybrid_mesh_shape(*args)
        return
    assert D.hybrid_mesh_shape(*args) == want
    with pytest.raises(ValueError, match="must not cross nodes"):
        D.hybrid_mesh_shape(32, 4, model=16)


def test_is_primary_and_gating(no_launcher):
    assert D.is_primary()  # single process: rank 0
    calls = []

    @D.primary_only
    def save(x):
        calls.append(x)
        return x

    assert save(1) == 1 and calls == [1]
    no_launcher.setenv("RANK", "1")
    assert not D.is_primary() and save(2) is None and calls == [1]
    no_launcher.setenv("RANK", "0")
    assert D.is_primary()


def test_is_primary_without_identity_raises(no_launcher):
    """WORLD_SIZE > 1 and no RANK before init: no truthful answer, so it
    raises rather than make every rank primary."""
    no_launcher.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="maybe_initialize"):
        D.is_primary()
    no_launcher.setenv("RANK", "3")
    assert D.is_primary() is False


def test_setup_logging_primary_gate(monkeypatch, tmp_path):
    root = logging.getLogger()
    level = root.level
    monkeypatch.setattr(D, "is_primary", lambda: False)
    n0 = len(root.handlers)
    try:
        assert PL.setup_logging(log_dir=str(tmp_path)) == ""
        assert len(root.handlers) == n0  # no new handlers
        assert root.level == logging.WARNING
        assert not any(tmp_path.iterdir())
    finally:
        root.setLevel(level)


class _Axes:
    """What zero1_specs reads of a device mesh: its axes' sizes."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int):
        self.data = data

    def size(self, dim):
        return (self.data, 1)[dim]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zero1_specs_match_reference(n):
    shapes = {"a": (8,), "b": (3,), "c": (16, 4), "d": (3, 8), "e": (),
              "f": {"g": (6, 9), "h": (2, 2)}, "i": (7, 12), "j": (1, 24)}

    def leaves(tree):
        if isinstance(tree, dict):
            return {k: leaves(v) for k, v in tree.items()}
        return jax.ShapeDtypeStruct(tree, "float32")

    mesh = r_create_mesh(RMeshConfig(data=n, model=1), jax.devices()[:n])
    want = jax.tree.leaves(r_zero1_specs(leaves(shapes), mesh),
                           is_leaf=lambda s: isinstance(s, JP))
    import torch

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return torch.zeros(tree)

    got = zero1_specs(tensors(shapes), _Axes(n))
    flat = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            flat.append(t)

    walk(got)
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        if "data" in tuple(w):
            assert g == Shard(tuple(w).index("data")), (g, w)
        else:
            assert g == Replicate(), (g, w)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_create_mesh_at_one_rank_on_gloo(no_launcher):
    """maybe_initialize (gloo, idempotent), create_mesh / global_mesh and
    the placements at world 1; the group is torn down after."""
    cfg = D.DistributedConfig(coordinator_address=f"127.0.0.1:"
                                                  f"{_free_port()}",
                              num_processes=1, process_id=0)
    with pytest.raises(ValueError, match="device"):
        D.maybe_initialize(cfg, device="tpu")
    with pytest.raises(RuntimeError, match="process group"):
        M.create_mesh(device="cpu")
    assert not dist.is_initialized()
    try:
        assert D.maybe_initialize(cfg, device="cpu") is True
        assert D.maybe_initialize(cfg, device="cpu") is True
        assert dist.get_backend() == "gloo" and D.is_primary()
        mesh = M.create_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert M.axis_coordinate(mesh) == (0, 1)
        assert M.axis_size(mesh, "seq") == 1
        # a collective would read a None group as the whole world
        with pytest.raises(ValueError, match="no 'seq' axis"):
            M.axis_group(mesh, "seq")
        assert M.data_sharding(mesh, 4) == (Shard(0), Replicate())
        assert M.replicated(mesh) == (Replicate(), Replicate())
        with pytest.raises(ValueError, match="2x1x1 != 1"):
            M.create_mesh(M.MeshConfig(data=2), device="cpu")
        assert D.global_mesh(device="cpu").mesh_dim_names == \
            ("data", "model")
        with pytest.raises(ValueError, match="does not divide"):
            D.global_mesh(model=2, device="cpu")
        assert M.active_mesh() is None
        with M.with_mesh(mesh):
            assert M.active_mesh() is mesh
        assert M.active_mesh() is None
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
