"""Flax parameter trees to port ``state_dict``s.

``params_from_flax(tree, cfg)`` takes the nested dict of numpy arrays that
``jax.tree_util`` gives for a ``cron_operator_tpu`` ``GPT`` (its
``["params"]`` collection, converted with ``np.asarray``) and returns the
``state_dict`` of the port's :class:`models.gpt.GPT` for the same config.
A flax kernel ``[in..., out...]`` becomes a torch ``Linear`` weight
``[out, in]`` after flattening each side; biases flatten.
:func:`flax_rank` goes the other way for the one property of a flax shape
that training reads: its rank.
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


def params_from_flax(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """f32 ``state_dict`` for the port's GPT from a flax GPT param tree."""
    if cfg.moe_every > 0:
        raise NotImplementedError("MoE parameter trees wait for the MoE slice")
    sd: Dict[str, torch.Tensor] = {
        "tok_emb.weight": _tensor(tree["tok_emb"]["embedding"]),
    }
    if not cfg.rope:
        sd["pos_emb"] = _tensor(tree["pos_emb"])
    mha = (cfg.num_kv_heads or cfg.num_heads) == cfg.num_heads
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
        sd.update(_linear(node["Dense_0"], 1, f"{p}.fc_in"))
        sd.update(_linear(node["Dense_1"], 1, f"{p}.fc_out"))
    sd.update(_layer_norm(tree["LayerNorm_0"], "ln_f"))
    return sd


__all__ = ["flax_rank", "params_from_flax"]
