"""Utilities of the port: device resolution."""

from cron_operator_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
