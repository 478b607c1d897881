"""Parallelism layer of the port. Only dense single-device attention
exists so far (:mod:`parallel.ring`); meshes, ring/Ulysses, MoE and
pipelines come with later slices (ROADMAP.md queue 1)."""
