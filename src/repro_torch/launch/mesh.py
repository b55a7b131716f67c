"""Production mesh definitions.

Counterpart of `repro.launch.mesh`. The shapes are the reference's TPU
v5e pods: 16 x 16 = 256 chips a pod, two pods = 512 chips. The port
builds them as abstract `distributed.sharding.Mesh` grids, without
devices: they give the sharding specs (`distributed.sharding.param_specs`
and its siblings) of meshes larger than the machine. Importing this
module touches no device.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_rules", "mesh_device_count"]


def make_production_mesh(*, multi_pod: bool = False):
    """The abstract (16, 16) ("data", "model") pod mesh, or (2, 16, 16)
    with "pod" in front."""
    from repro_torch.distributed.sharding import Mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def mesh_device_count(*, multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


def make_rules(mesh, *, fsdp: bool = True, fsdp_over_pod: bool = False):
    """ShardingRules for a production mesh (single- or multi-pod)."""
    from repro_torch.distributed.sharding import ShardingRules

    multi_pod = "pod" in mesh.axis_names
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    fsdp_axes = dp_axes if (multi_pod and fsdp_over_pod) else ("data",)
    return ShardingRules(
        mesh=mesh,
        dp_axes=dp_axes,
        model_axis="model",
        fsdp_axes=fsdp_axes,
        fsdp=fsdp,
    )
