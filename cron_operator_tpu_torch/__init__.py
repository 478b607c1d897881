"""cron_operator_tpu_torch — the PyTorch/CUDA port of ``cron_operator_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100). It imports
``torch`` and nothing of JAX or of ``cron_operator_tpu``; the operator's
control plane reaches its workloads only through ``module:function``
entrypoint strings (``tpu.kubedl.io/entrypoint``), so it launches them
unchanged. Sub-packages mirror the JAX package's:

- ``backends`` — the ``JobContext`` an entrypoint receives, the entrypoint
                 registry, the card's peak FLOP/s.
- ``ops``      — the hand-written Hopper kernels (``ops/csrc``) with their
                 plain PyTorch versions, attention dispatch, RoPE, chunked
                 cross-entropy.
- ``parallel`` — dense single-device attention, multi-step dispatch and
                 the Switch-MoE FFN (meshes come later).
- ``models``   — the GPT family (MoE blocks included), BERT, ViT,
                 ResNet, the MLP and the flax-to-torch weight converter.
- ``workloads``— KV-cache generation, synthetic data, the training harness,
                 checkpoints, the entrypoints (``generate_job``, ``gpt``,
                 ``bert``, ``mnist``, ``resnet50``, ``vit``) and the pod
                 runner.
- ``utils``    — device resolution.

Entry points run on the CUDA card; they use the CPU only when the caller
asks (``param.platform=cpu`` or ``device="cpu"``).
"""

__version__ = "0.1.0"
