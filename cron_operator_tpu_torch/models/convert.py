"""Flax parameter trees to port ``state_dict``s.

Each converter takes the nested dict of numpy arrays that
``jax.tree_util`` gives for a ``cron_operator_tpu`` model (its
``["params"]`` collection, converted with ``np.asarray``) and returns the
``state_dict`` of the port's model of the same config:
:func:`params_from_flax` for GPT and BERT (one layout), and
:func:`vit_params_from_flax`, :func:`resnet_params_from_flax` and
:func:`mlp_params_from_flax`. A flax kernel ``[in..., out...]`` becomes a
torch ``Linear`` weight ``[out, in]`` after flattening each side; biases
flatten; a conv kernel goes from HWIO to OIHW; MoE expert weights keep
their layout. :func:`flax_rank` goes the other way for the one property of
a flax shape that training reads: its rank.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


# Biases whose flax shape has more than one axis: ``qkv`` is (3, heads,
# head_dim), ``q`` (heads, head_dim), ``kv`` (2, kv_heads, head_dim). The port
# flattens them to rank 1.
_FLAX_BIAS_RANKS = {"attn.qkv.bias": 3, "attn.q.bias": 2, "attn.kv.bias": 3}


def flax_rank(name: str, param: torch.Tensor) -> int:
    """The rank the flax tree gives the port's parameter ``name``: every
    flattened multi-axis bias has its flax rank back, every other parameter
    keeps its own (kernels, embeddings and norms have one rank on both
    sides)."""
    for suffix, rank in _FLAX_BIAS_RANKS.items():
        if name.endswith(suffix):
            return rank
    return param.ndim


def _tensor(array) -> torch.Tensor:
    """An f32 torch copy (jax's numpy views are read-only)."""
    return torch.tensor(np.asarray(array, dtype=np.float32))


def _linear(node: Mapping[str, Any], n_in_axes: int, prefix: str) -> Dict:
    kernel = np.asarray(node["kernel"], dtype=np.float32)
    n_in = int(np.prod(kernel.shape[:n_in_axes]))
    return {
        f"{prefix}.weight": _tensor(kernel.reshape(n_in, -1).T),
        f"{prefix}.bias": _tensor(node["bias"]).reshape(-1),
    }


def _layer_norm(node: Mapping[str, Any], prefix: str) -> Dict:
    return {
        f"{prefix}.weight": _tensor(node["scale"]),
        f"{prefix}.bias": _tensor(node["bias"]),
    }


def _conv(node: Mapping[str, Any], prefix: str) -> Dict:
    kernel = np.asarray(node["kernel"], dtype=np.float32)  # HWIO
    sd = {f"{prefix}.weight": _tensor(kernel.transpose(3, 2, 0, 1))}
    if "bias" in node:
        sd[f"{prefix}.bias"] = _tensor(node["bias"])
    return sd


def _encoder_stack(tree: Mapping[str, Any], cfg) -> Dict:
    """The pre-LN blocks (``layers.{i}``), the final LayerNorm and the
    learned positions of GPT, BERT or ViT."""
    mha = (cfg.num_kv_heads or cfg.num_heads) == cfg.num_heads
    sd: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        node = tree[f"layer_{i}"]
        p = f"layers.{i}"
        sd.update(_layer_norm(node["LayerNorm_0"], f"{p}.ln_attn"))
        if mha:
            sd.update(_linear(node["qkv"], 1, f"{p}.attn.qkv"))
        else:
            sd.update(_linear(node["q"], 1, f"{p}.attn.q"))
            sd.update(_linear(node["kv"], 1, f"{p}.attn.kv"))
        sd.update(_linear(node["out"], 2, f"{p}.out"))
        sd.update(_layer_norm(node["LayerNorm_1"], f"{p}.ln_mlp"))
        if "moe" in node:
            # MoE blocks keep JAX's layout: no transposes
            for name in ("router", "wi", "wo"):
                sd[f"{p}.moe.{name}"] = _tensor(node["moe"][name])
        else:
            sd.update(_linear(node["Dense_0"], 1, f"{p}.fc_in"))
            sd.update(_linear(node["Dense_1"], 1, f"{p}.fc_out"))
    sd.update(_layer_norm(tree["LayerNorm_0"], "ln_f"))
    if not cfg.rope:
        sd["pos_emb"] = _tensor(tree["pos_emb"])
    return sd


def params_from_flax(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """f32 ``state_dict`` for the port's GPT or BERT (``cfg`` a
    ``GPTConfig`` or ``BertConfig``) from its flax param tree; a GPT's MoE
    blocks (``layer_{i}/moe/{router,wi,wo}``) map one to one."""
    sd = {"tok_emb.weight": _tensor(tree["tok_emb"]["embedding"])}
    sd.update(_encoder_stack(tree, cfg))
    return sd


def vit_params_from_flax(tree: Mapping[str, Any],
                         cfg) -> Dict[str, torch.Tensor]:
    """f32 ``state_dict`` for the port's ViT from a flax ViT param tree."""
    sd = _conv(tree["patch_embed"], "patch_embed")
    sd["cls_token"] = _tensor(tree["cls_token"])
    sd.update(_encoder_stack(tree, cfg))
    sd.update(_linear(tree["head"], 1, "head"))
    return sd


def resnet_params_from_flax(tree: Mapping[str, Any],
                            model) -> Dict[str, torch.Tensor]:
    """f32 ``state_dict`` for the port's ResNet ``model`` from the flax
    tree of the same stages: ``Conv_0``/``GroupNorm_0`` (the stem),
    ``<Block>_{j}`` with its ``Conv_i``/``GroupNorm_i`` in creation order,
    and ``Dense_0`` (the head)."""
    sd = _conv(tree["Conv_0"], "stem")
    sd.update(_layer_norm(tree["GroupNorm_0"], "stem_norm"))
    for j, block in enumerate(model.blocks):
        node = tree[f"{type(block).__name__}_{j}"]
        for i in range(len(block.convs)):
            sd.update(_conv(node[f"Conv_{i}"], f"blocks.{j}.convs.{i}"))
            sd.update(_layer_norm(node[f"GroupNorm_{i}"],
                                  f"blocks.{j}.norms.{i}"))
    sd.update(_linear(tree["Dense_0"], 1, "head"))
    return sd


def mlp_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """f32 ``state_dict`` for the port's MLP from a flax MLP param tree."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(tree)):
        sd.update(_linear(tree[f"Dense_{i}"], 1, f"dense.{i}"))
    return sd


__all__ = [
    "flax_rank",
    "mlp_params_from_flax",
    "params_from_flax",
    "resnet_params_from_flax",
    "vit_params_from_flax",
]
