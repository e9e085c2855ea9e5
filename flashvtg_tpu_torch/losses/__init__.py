from flashvtg_tpu_torch.losses.criterion import (
    LossConfig,
    compute_losses,
    loss_keys,
    weighted_total,
)


def declared_loss_keys(loss_cfg):
    """Sorted key order of the train step's loss dict for `loss_cfg` (() for
    None), the weighted total included (JAX losses/__init__.py)."""
    if loss_cfg is None:
        return ()
    return tuple(sorted(loss_keys(loss_cfg) + ("weighted_loss_overall",)))


__all__ = ["LossConfig", "compute_losses", "declared_loss_keys", "loss_keys",
           "weighted_total"]
