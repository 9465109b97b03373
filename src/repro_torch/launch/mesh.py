"""Production mesh construction.

Functions (not module-level constants), so that importing this module
touches no process group.  The JAX package builds its meshes over the
devices of one controller; here a mesh is a ``torch.distributed``
``DeviceMesh`` over the ranks of the initialised default process group
(one process per rank, ``sharding.world.init_world``), of the JAX
package's shapes and dim names.  A world that does not have exactly that
many ranks raises, as ``ShardingPlan.make_mesh`` does for a plan larger
than the world.
"""

from __future__ import annotations


def _mesh(shape, axes):
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.plan import world_size

    n, world = math.prod(shape), world_size()
    if world != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh {tuple(axes)} needs {n} "
            f"ranks, the process group has {world}; start one process per "
            f"rank (torchrun --nproc-per-node {n})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The (data 16, model 16) mesh, or (pod 2, data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A small mesh for multi-rank tests."""
    return _mesh(shape, axes)
