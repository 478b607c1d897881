"""Parallelism layer of the port: dense single-device attention
(:mod:`parallel.ring`) and multi-step dispatch and staging
(:mod:`parallel.overlap`); meshes, ring/Ulysses, MoE and pipelines come
with later slices (ROADMAP.md queue 1)."""
