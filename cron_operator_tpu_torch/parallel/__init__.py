"""Parallelism layer of the port: device meshes over the process group and
their placement rules (:mod:`parallel.mesh`), dense single-device
attention (:mod:`parallel.ring`), multi-step dispatch and staging
(:mod:`parallel.overlap`) and the Switch-MoE FFN, its experts placeable
on the ``expert`` axis (:mod:`parallel.moe`); ring/Ulysses and pipelines
come with later slices (ROADMAP.md queue 1)."""

from cron_operator_tpu_torch.parallel.mesh import (
    MeshPlan,
    make_mesh,
    mesh_for_devices,
    plan_for_devices,
    regrow,
    replan,
    sharding_for_tree,
)
from cron_operator_tpu_torch.parallel.moe import (
    init_moe_params,
    moe_ffn,
    moe_param_sharding,
    router_top1,
)

__all__ = ["MeshPlan", "init_moe_params", "make_mesh", "mesh_for_devices",
           "moe_ffn", "moe_param_sharding", "plan_for_devices", "regrow",
           "replan", "router_top1", "sharding_for_tree"]
