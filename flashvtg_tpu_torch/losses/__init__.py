from flashvtg_tpu_torch.losses.criterion import (
    LossConfig,
    compute_losses,
    loss_keys,
    weighted_total,
)
from flashvtg_tpu_torch.losses.criterion_ms import (
    MSLossConfig,
    compute_losses_ms,
    loss_keys_ms,
    weighted_total_ms,
)


def declared_loss_keys(loss_cfg):
    """Sorted key order of the train step's loss dict for `loss_cfg`, core
    or _ms (() for None), the weighted total included (JAX
    losses/__init__.py)."""
    if loss_cfg is None:
        return ()
    base = loss_keys_ms(loss_cfg) if isinstance(loss_cfg, MSLossConfig) else loss_keys(loss_cfg)
    return tuple(sorted(base + ("weighted_loss_overall",)))


def criterion(loss_cfg, outputs, targets):
    """The loss dict of `loss_cfg`'s criterion (core or _ms) on a forward's
    outputs, the weighted total under "weighted_loss_overall"."""
    if isinstance(loss_cfg, MSLossConfig):
        losses = compute_losses_ms(outputs, targets, loss_cfg)
        losses["weighted_loss_overall"] = weighted_total_ms(losses, loss_cfg)
    else:
        losses = compute_losses(outputs, targets, loss_cfg)
        losses["weighted_loss_overall"] = weighted_total(losses, loss_cfg)
    return losses


__all__ = ["LossConfig", "MSLossConfig", "compute_losses", "compute_losses_ms",
           "criterion", "declared_loss_keys", "loss_keys", "loss_keys_ms",
           "weighted_total", "weighted_total_ms"]
