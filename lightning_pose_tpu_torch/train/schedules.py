"""Learning-rate and anneal-weight schedules as functions of the step
(counterpart of ``lightning_pose_tpu/train/schedules.py``).

Each schedule maps the global step (an int) to a float. The trainer sets
each parameter group's ``lr`` from its schedule before every optimizer step,
which is when the reference's optax schedules read the step count.
"""

from __future__ import annotations

__all__ = ["anneal_weight", "backbone_lr", "multistep_lr"]


def multistep_lr(base_lr: float, milestones: list[int], gamma: float, steps_per_epoch: int):
    """MultiStepLR: multiply by ``gamma`` at each milestone epoch."""
    boundaries = [m * steps_per_epoch for m in sorted(milestones)]

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in boundaries)

    return schedule


def backbone_lr(
    base_lr: float,
    milestones: list[int],
    gamma: float,
    steps_per_epoch: int,
    unfreezing_epoch: int | None = None,
    unfreezing_step: int | None = None,
    initial_ratio: float = 0.1,
    warm_up_ratio: float = 1.5,
):
    """Backbone LR: 0 until the unfreeze, then from ``initial_ratio`` times
    the head LR at the unfreeze it grows by ``warm_up_ratio`` per epoch (epoch
    mode) or per step (step mode) until it reaches the head LR."""
    if (unfreezing_epoch is None) == (unfreezing_step is None):
        raise ValueError("give exactly one of unfreezing_epoch and unfreezing_step")
    head = multistep_lr(base_lr, milestones, gamma, steps_per_epoch)
    if unfreezing_epoch is not None:
        unfreeze_unit = unfreezing_epoch
        unfreeze_step0 = unfreezing_epoch * steps_per_epoch
        per = steps_per_epoch
    else:
        unfreeze_unit = unfreezing_step
        unfreeze_step0 = unfreezing_step
        per = 1
    initial = initial_ratio * head(unfreeze_step0)

    def schedule(step: int) -> float:
        unit = step // per
        if unit < unfreeze_unit:
            return 0.0
        return min(initial * warm_up_ratio ** (unit - unfreeze_unit), head(step))

    return schedule


def anneal_weight(
    epoch: int,
    init_val: float = 0.0,
    increase_factor: float = 0.01,
    final_val: float = 1.0,
    freeze_until_epoch: int = 0,
) -> float:
    """Unsupervised-loss importance: ``init_val`` through
    ``freeze_until_epoch``, then up by ``increase_factor`` per epoch, capped
    at ``final_val``."""
    if epoch <= freeze_until_epoch:
        return init_val
    return min(init_val + (epoch - freeze_until_epoch) * increase_factor, final_val)
