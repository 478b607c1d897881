"""Training harness of the port, as in ``cron_operator_tpu/workloads/train.py``.

One optimizer step per dispatch (the JAX package's ``steps_per_call=1``)
on one device, in eager PyTorch: the forward, the loss, the backward
(through the Hopper flash kernels K1-K3 when attention runs on the card),
the optional global-norm clip and the optimizer update. The JAX ``Trainer``
jits that step over a mesh; the port has no mesh yet and nothing to
compile, so the first step's wall time, which the JAX package reports as
its compile time, here holds the kernels' build (unless prebuilt) and the
allocator's warm-up.

The optimizer follows optax: AdamW with its defaults (b1 0.9, b2 0.999, eps
1e-8) and ``TrainConfig.weight_decay``, or SGD with momentum 0.9; the
learning rate is evaluated at the optimizer's pre-increment step count, as
optax's schedules are; ``decay_mask`` selects parameters by the rank of
their flax shape; the clip is ``optax.clip_by_global_norm`` (no epsilon
added to the norm, unlike ``torch.nn.utils.clip_grad_norm_``).

Not here yet: multi-step dispatch (``steps_per_call > 1``), background
staging (batches are put on the device inline) and checkpoints.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cron_operator_tpu_torch.models.convert import flax_rank

ADAM_BETAS = (0.9, 0.999)  # optax.adamw's b1, b2
ADAM_EPS = 1e-8  # optax.adamw's eps (eps_root 0)
SGD_MOMENTUM = 0.9


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; labels are int classes, any leading dims."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    optimizer: str = "adamw"  # adamw | sgd
    # "constant", "cosine" (to 0 over schedule_steps) or "warmup_cosine"
    # (linear 0 -> lr over warmup_steps, then cosine to 0 at schedule_steps)
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    schedule_steps: int = 0
    grad_clip_norm: float = 0.0  # global-norm clip before the optimizer; 0 off
    # AdamW weight decay only on parameters whose flax shape has rank >= 2
    decay_mask: bool = False
    remat: bool = False  # recompute the forward in the backward
    sync_every: int = 1  # fetch the loss (a device sync) every N steps

    def lr_at(self) -> Callable[[int], float]:
        """The learning rate as a function of the optimizer's step count,
        value for value the optax schedule the JAX package builds."""
        lr = self.learning_rate
        if self.lr_schedule == "constant":
            return lambda count: lr
        if self.lr_schedule not in ("cosine", "warmup_cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.schedule_steps <= 0:
            raise ValueError(
                f"lr_schedule={self.lr_schedule!r} needs schedule_steps > 0"
            )

        def cosine(peak: float, decay_steps: int):
            if decay_steps <= 0:
                raise ValueError(
                    f"the cosine decay needs positive decay steps, got "
                    f"{decay_steps}"
                )

            def at(count):
                count = min(count, decay_steps)
                return peak * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
            return at

        if self.lr_schedule == "cosine":
            return cosine(lr, self.schedule_steps)
        # optax.warmup_cosine_decay_schedule(0, lr, max(1, warmup),
        # max(warmup + 1, schedule_steps)): a linear ramp joined to a cosine
        # that starts at the boundary.
        warmup = max(1, self.warmup_steps)
        decay = cosine(lr, max(self.warmup_steps + 1, self.schedule_steps)
                       - warmup)

        def at(count):
            if count < warmup:
                return lr * min(max(count, 0), warmup) / warmup
            return decay(count - warmup)
        return at

    def make_optimizer(self, model: nn.Module) -> torch.optim.Optimizer:
        """optax's ``adamw`` (masked by flax rank when ``decay_mask``) or
        ``sgd(momentum=0.9)`` over ``model``'s parameters; the learning rate
        is set before each step (:meth:`Trainer.step`)."""
        if self.decay_mask and self.optimizer != "adamw":
            raise ValueError(
                "decay_mask requires the adamw optimizer "
                f"(got {self.optimizer!r})"
            )
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        fused = bool(params) and params[0][1].is_cuda
        if self.optimizer == "adamw":
            if self.decay_mask:
                groups = [
                    {"params": [p for n, p in params if flax_rank(n, p) >= 2]},
                    {"params": [p for n, p in params if flax_rank(n, p) < 2],
                     "weight_decay": 0.0},
                ]
                groups = [g for g in groups if g["params"]]
            else:
                groups = [{"params": [p for _, p in params]}]
            return torch.optim.AdamW(
                groups, lr=self.learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
                weight_decay=self.weight_decay, fused=fused or None,
            )
        if self.optimizer == "sgd":
            return torch.optim.SGD(
                [p for _, p in params], lr=self.learning_rate,
                momentum=SGD_MOMENTUM, fused=fused or None,
            )
        raise ValueError(f"unknown optimizer {self.optimizer!r}")


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: when the global norm reaches
    ``max_norm``, every gradient is scaled by ``max_norm / norm``. No
    epsilon is added to the norm (``clip_grad_norm_`` adds 1e-6), and the
    decision stays on the device."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))


@dataclass
class StepStats:
    step: int
    loss: Optional[float]  # None on async (non-synced) steps
    step_time_s: float
    # Phase walls of the step, in seconds: data = putting the batch on the
    # device, dispatch = enqueueing forward, backward and update, sync =
    # waiting for the loss (0.0 on async steps).
    data_s: float = 0.0
    dispatch_s: float = 0.0
    sync_s: float = 0.0
    compiled: bool = False  # the first dispatch (kernel build, warm-up)


class Trainer:
    """Owns a model, its optimizer and the step loop.

    ``model(x)`` gives the output ``loss_fn(output, y)`` reads. The model's
    parameters stay where they are; batches go to their device.
    """

    def __init__(
        self,
        model: nn.Module,
        config: Optional[TrainConfig] = None,
        loss_fn: Callable[[Any, torch.Tensor], torch.Tensor] = cross_entropy_loss,
    ):
        self.model = model
        self.config = config or TrainConfig()
        self.loss_fn = loss_fn
        self.device = next(model.parameters()).device
        self.optimizer = self.config.make_optimizer(model)
        self._lr_at = self.config.lr_at()
        self.steps_done = 0
        # Wall time of the first dispatch (see the module docstring).
        self.first_dispatch_time_s: Optional[float] = None

    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.config.remat:
            out = checkpoint(self.model, batch["x"], use_reentrant=False)
        else:
            out = self.model(batch["x"])
        return self.loss_fn(out, batch["y"])

    def _update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward, backward, clip and optimizer step, all enqueued; returns
        the loss on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(batch)
        loss.backward()
        if self.config.grad_clip_norm > 0:
            grads = [p.grad for g in self.optimizer.param_groups
                     for p in g["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.config.grad_clip_norm)
        lr = self._lr_at(self.steps_done)  # optax: the pre-increment count
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return loss.detach()

    def step(self, batch: Dict[str, Any], sync: bool = True) -> StepStats:
        """One optimizer step. ``sync=False`` leaves the loss on the device
        (its StepStats carry ``loss=None``) so that the caller can amortise
        the round trip (``TrainConfig.sync_every``)."""
        compiled = self.first_dispatch_time_s is None
        t0 = time.perf_counter()
        device_batch = self.put_batch(batch)
        t_data = time.perf_counter()
        loss = self._update(device_batch)
        t_disp = time.perf_counter()
        loss = float(loss) if sync else None
        wall = time.perf_counter() - t0
        sync_s = time.perf_counter() - t_disp if sync else 0.0
        if compiled:
            self.first_dispatch_time_s = wall
        self.steps_done += 1
        return StepStats(
            self.steps_done, loss, wall,
            data_s=t_data - t0,
            dispatch_s=t_disp - t_data,
            sync_s=sync_s,
            compiled=compiled,
        )

    def run(
        self,
        batches: Iterator[Dict[str, Any]],
        steps: int,
        should_stop: Optional[Callable[[], bool]] = None,
        on_step: Optional[Callable[[StepStats], None]] = None,
    ) -> List[StepStats]:
        """Train until ``steps_done`` reaches ``steps`` (a total-step
        target). The first and the last step, and every ``sync_every``-th
        step between, fetch the loss; after an early exit behind async steps
        the device is drained and the drain charged to the last step."""
        se = max(1, self.config.sync_every)
        first = self.steps_done + 1
        stats: List[StepStats] = []
        try:
            while self.steps_done < steps:
                if should_stop is not None and should_stop():
                    break
                nxt = self.steps_done + 1
                sync = (
                    nxt == first or nxt >= steps
                    or (nxt - first + 1) // se > (nxt - first) // se
                )
                s = self.step(next(batches), sync=sync)
                stats.append(s)
                if on_step is not None:
                    on_step(s)
        finally:
            if stats and stats[-1].loss is None and self.device.type == "cuda":
                t0 = time.perf_counter()
                torch.cuda.synchronize(self.device)
                stats[-1].step_time_s += time.perf_counter() - t0
        return stats


__all__ = [
    "StepStats",
    "TrainConfig",
    "Trainer",
    "clip_by_global_norm_",
    "cross_entropy_loss",
]
