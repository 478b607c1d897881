"""Models of the port: GPT (dense and Switch-MoE blocks), BERT, the MLP,
ResNet and ViT, and the flax-to-torch weight converters
(``models/convert.py``)."""

from cron_operator_tpu_torch.models.bert import Bert, BertConfig
from cron_operator_tpu_torch.models.gpt import GPT, GPTConfig, MoEBlock
from cron_operator_tpu_torch.models.mlp import MLP
from cron_operator_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50
from cron_operator_tpu_torch.models.vit import ViT, ViTConfig

__all__ = [
    "MLP", "ResNet", "ResNet18", "ResNet50", "Bert", "BertConfig",
    "GPT", "GPTConfig", "MoEBlock", "ViT", "ViTConfig",
]
