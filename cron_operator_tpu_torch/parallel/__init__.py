"""Parallelism layer of the port: dense single-device attention
(:mod:`parallel.ring`), multi-step dispatch and staging
(:mod:`parallel.overlap`) and the Switch-MoE FFN on one device
(:mod:`parallel.moe`); meshes (the expert axis among them), ring/Ulysses
and pipelines come with later slices (ROADMAP.md queue 1)."""

from cron_operator_tpu_torch.parallel.moe import (
    init_moe_params,
    moe_ffn,
    router_top1,
)

__all__ = ["init_moe_params", "moe_ffn", "router_top1"]
