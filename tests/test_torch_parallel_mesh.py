"""parallel/mesh.py on the CPU: entity padding against the JAX package's,
the rank <-> (d, m) layout and its groups, the refusals, the row-sharded
model and gather, and the process-safe kernel build.  No process group is
started here: make_mesh's calls into torch.distributed are recorded."""

import stat
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.kernels import _build as KB
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.parallel import mesh as M
from complexhyperbolickge_tpu import parallel as JP

ROOT = Path(__file__).resolve().parents[1]


def _trees():
    """JAX's row-coincident bystander case (tests/test_parallel.py): 63
    entities and a 64-row rel under a 2-wide model axis, the params and an
    optax-style moment tree mirroring them."""
    params = {
        "entity": np.ones((63, 4)),
        "bh": np.ones((63, 1)),
        "bt": np.full((63, 1), 2.0),
        "rel": np.arange(64 * 4, dtype=np.float64).reshape(64, 4),
        "c": np.ones((64, 1)),
    }
    moments = {"mu": {k: v * 0.5 for k, v in params.items()},
               "count": np.asarray(3)}
    return params, moments


@pytest.mark.parametrize("which", ["params", "moments"])
def test_pad_unpad_equal_jax_and_keep_bystanders(which):
    tree = dict(zip(("params", "moments"), _trees()))[which]
    np_ = M.padded_rows(63, 2)
    assert np_ == JP.padded_rows(63, 2) == 64
    got = M.pad_entity_tree(tree, 63, np_)
    want = JP.pad_entity_tree(tree, 63, np_)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    un = M.unpad_entity_tree(got, 63, np_)
    jun = JP.unpad_entity_tree(want, 63, np_)
    for a, b, c in zip(jax.tree.leaves(un), jax.tree.leaves(jun), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    rel = got["rel"] if which == "params" else got["mu"]["rel"]
    assert rel.shape == (64, 4)  # the bystander is never padded nor cut


def test_pad_and_unpad_take_torch_tensors_and_the_port_opt_state():
    """The port's optimizer state nests name -> torch key (the other way
    round from optax): its entity leaves are padded too, and its 0-d step
    is left alone."""
    st = {"lr": 0.1, "state": {"entity": {"step": np.asarray(2.0),
                                          "exp_avg": np.ones((5, 3))},
                               "rel": {"exp_avg": np.ones((6, 3))}}}
    p = M.pad_entity_tree(st, 5, 6)
    assert p["state"]["entity"]["exp_avg"].shape == (6, 3)
    assert p["state"]["rel"]["exp_avg"].shape == (6, 3)
    assert p["state"]["entity"]["step"].shape == ()
    t = M.pad_entity_tree({"bt": torch.ones(5, 1, dtype=torch.float64)}, 5, 8)["bt"]
    assert t.dtype == torch.float64 and t.shape == (8, 1) and float(t[5:].abs().sum()) == 0.0
    assert M.unpad_entity_tree(p, 5, 6)["state"]["entity"]["exp_avg"].shape == (5, 3)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_shards_cover_the_padded_table(n_shards):
    params, _ = _trees()
    parts = [M.shard_entity_tree(params, 63, i, n_shards) for i in range(n_shards)]
    full = M.pad_entity_tree(params, 63, M.padded_rows(63, n_shards))
    for k in ("entity", "bh", "bt"):
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), full[k])
    assert all(p["rel"] is params["rel"] for p in parts)


def test_shard_model_keeps_its_rows_and_the_rest():
    n = 49
    model = get_model("FFTRotH")(ModelConfig(n_entities=n, n_relations=4, rank=4,
                                             dtype="float64"))
    full = {k: v.clone() for k, v in model.state_dict().items()}
    names = M.shard_model_(model, 3, 4)
    assert names == ["entity", "bh", "bt"]
    assert model.entity.shape == (13, 8) and isinstance(model.entity, torch.nn.Parameter)
    np.testing.assert_array_equal(model.entity.detach()[:10].numpy(), full["entity"][39:].numpy())
    assert float(model.entity.detach()[10:].abs().sum()) == 0.0
    np.testing.assert_array_equal(model.rel.detach().numpy(), full["rel"].numpy())


class _FakeDist:
    """torch.distributed as make_mesh sees it, for one rank of a world."""

    def __init__(self, rank, world):
        self.rank, self.world, self.groups = rank, world, []

    def install(self, monkeypatch):
        monkeypatch.setattr(M.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(M.dist, "get_world_size", lambda: self.world)
        monkeypatch.setattr(M.dist, "get_rank", lambda: self.rank)
        monkeypatch.setattr(M.dist, "new_group", lambda ranks: self.groups.append(ranks)
                            or tuple(ranks))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 8), (3, 2)])
def test_rank_layout_and_groups(shape, monkeypatch):
    d_, m_ = shape
    seen = []
    for r in range(d_ * m_):
        fake = _FakeDist(r, d_ * m_)
        fake.install(monkeypatch)
        mesh = M.make_mesh(shape)
        assert (mesh.d, mesh.m) == (r // m_, r % m_)
        # every rank builds every group, in one order
        want = ([[d * m_ + m for m in range(m_)] for d in range(d_)] if m_ > 1 else []) + \
               ([[d * m_ + m for d in range(d_)] for m in range(m_)] if d_ > 1 else [])
        assert fake.groups == want
        assert (mesh.model_group is None) == (m_ == 1)
        assert (mesh.data_group is None) == (d_ == 1)
        if m_ > 1:
            assert list(mesh.model_group) == [mesh.d * m_ + m for m in range(m_)]
        if d_ > 1:
            assert list(mesh.data_group) == [d * m_ + mesh.m for d in range(d_)]
        seen.append((mesh.d, mesh.m))
    assert sorted(seen) == [(d, m) for d in range(d_) for m in range(m_)]


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="initialized process group"):
        M.make_mesh((2, 1))
    _FakeDist(0, 4).install(monkeypatch)
    with pytest.raises(ValueError, match="needs 6 ranks, the process group has 4"):
        M.make_mesh((3, 2))
    with pytest.raises(ValueError, match="DATAxMODEL"):
        M.parse_shape("4by2")
    assert M.parse_shape("4X2") == (4, 2)
    assert M.make_mesh((1, 1)).size == 1


def test_batch_the_data_axis_does_not_divide_is_refused_as_in_jax():
    b = np.zeros((2, 64, 3), np.int32)
    w = np.ones((2, 64), np.float32)
    with pytest.raises(ValueError, match="not divisible by the mesh's data axis 3"):
        M.shard_epoch_arrays(M.Mesh((3, 1), 0), b, w)
    jmesh = JP.make_mesh((3, 1), devices=jax.devices()[:3])
    with pytest.raises(ValueError):
        JP.shard_epoch_arrays(jmesh, jnp.asarray(b), jnp.asarray(w))
    # a dividing axis: each data row takes its slice of every batch
    b = np.arange(2 * 64 * 3, dtype=np.int32).reshape(2, 64, 3)
    got = M.shard_epoch_arrays(M.Mesh((4, 2), 5), b, w, b)
    np.testing.assert_array_equal(got[0], b[:, 32:48])
    np.testing.assert_array_equal(got[2], b[:, 32:48])


_BUILD = """
import sys
from pathlib import Path
from complexhyperbolickge_torch.kernels import _build as KB
KB.BUILD_DIR = Path(sys.argv[1])
KB._nvcc = lambda: sys.argv[2]
KB.build_all(["gather"])
"""


def test_concurrent_builds_compile_each_library_once(tmp_path):
    """Two processes sharing a build directory: the file lock makes the
    second wait for the first's stamp and then skip the build."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo $$ >> {log}\n"
                    "sleep 0.5\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "echo lib > \"$2\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "kernels"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build), str(nvcc)], cwd=ROOT)
             for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert len(log.read_text().split()) == 1
    stamp = build / "libgather.so.sha256"
    assert stamp.read_text() == KB._digest("gather")


def test_node_layout_counts_the_ranks_on_each_host(monkeypatch):
    """Ranks launched with --coordinator learn their local rank and the
    ranks of their node from the host names in the rendezvous store."""
    import torch.distributed as dist

    from complexhyperbolickge_torch.cli import run as R

    hosts = ["a", "a", "b", "b", "b"]
    for rank, host in enumerate(hosts):
        store = dist.HashStore()
        for r, h in enumerate(hosts):
            if r != rank:
                store.set(f"host/{r}", h)
        monkeypatch.setattr(R.socket, "gethostname", lambda h=host: h)
        assert R.node_layout(store, len(hosts), rank) == (hosts[:rank].count(host),
                                                          hosts.count(host))


def test_device_and_backend_of_a_rank(monkeypatch):
    """NCCL when every rank of the node has a card of its own, gloo when
    ranks share one or run on the CPU; rank r of a node takes card
    r % device_count."""
    from complexhyperbolickge_torch.cli import run as R

    assert R.process_device("cpu", 1, 4) == (torch.device("cpu"), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, local_rank, local_world, want in [(1, 0, 1, ("cuda:0", "nccl")),
                                                 (1, 1, 2, ("cuda:0", "gloo")),
                                                 (4, 3, 4, ("cuda:3", "nccl")),
                                                 (4, 5, 8, ("cuda:1", "gloo"))]:
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        dev, backend = R.process_device("cuda", local_rank, local_world)
        assert (str(dev), backend) == want
