"""Parallelism layer of the port: device meshes over the process group and
their placement rules (:mod:`parallel.mesh`), sequence-parallel ring and
Ulysses attention over the ``seq`` axis (:mod:`parallel.ring`,
:mod:`parallel.ulysses`), GPipe pipelining over the ``pipe`` axis
(:mod:`parallel.pipeline`), multi-step dispatch and staging
(:mod:`parallel.overlap`) and the Switch-MoE FFN, its experts placeable on
the ``expert`` axis (:mod:`parallel.moe`)."""

from cron_operator_tpu_torch.parallel.mesh import (
    MeshPlan,
    batch_placements,
    hybrid_mesh_for_slices,
    make_mesh,
    mesh_for_devices,
    mesh_for_slice,
    placements_for_shape,
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
from cron_operator_tpu_torch.parallel.overlap import (
    DoubleBuffer,
    chunk_schedule,
)
from cron_operator_tpu_torch.parallel.pipeline import (
    pipeline_param_sharding,
    spmd_pipeline,
    stack_pipeline_stages,
)
from cron_operator_tpu_torch.parallel.ring import (
    ppermute,
    ring_attention,
    ring_attention_local,
)
from cron_operator_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_attention_local,
)

__all__ = ["DoubleBuffer", "MeshPlan", "batch_placements", "chunk_schedule",
           "hybrid_mesh_for_slices", "init_moe_params", "make_mesh",
           "mesh_for_devices", "mesh_for_slice", "moe_ffn",
           "moe_param_sharding", "pipeline_param_sharding",
           "placements_for_shape", "plan_for_devices", "ppermute", "regrow",
           "replan", "ring_attention", "ring_attention_local", "router_top1",
           "sharding_for_tree", "spmd_pipeline", "stack_pipeline_stages",
           "ulysses_attention", "ulysses_attention_local"]
