"""The criteria of the two variants and the step's view of them.

Under a split batch (parallel/mesh.py:split_batch, the data-parallel train
step) `criterion` computes the loss of the GLOBAL batch, as the JAX
criterion does on its sharded batch. Each rank first reduces what the
criterion reads of one row at a time on its own rows (`row_reductions`: the
sampled NCE's logits in place of the clip and query embeddings, the EOS
InfoNCE's positive clip in place of the context aggregate); the per-clip
and per-row outputs and targets the criterion then reads are gathered over
the ranks (`gather_rows`, differentiable), and every rank computes the same
global losses. The step backpropagates the global total divided by the
world size, each rank's share, so that the SUM of the ranks' gradients
(parallel/mesh.py:all_reduce_grads_) is the gradient of the global loss.
Gathering keeps every coupling of the batch exact in one place: the
normalisers over the batch (the row and positive counts, the avg_factors,
the means), loss_label's batch-wide min and max, the sampled NCE's and
loss_sal_ms's softmax over the batch's rows and the EOS InfoNCE's B x B
logits.
"""

from flashvtg_tpu_torch.losses.criterion import (
    LossConfig,
    batch_losses,
    compute_losses,
    loss_keys,
    row_reductions,
    weighted_total,
)
from flashvtg_tpu_torch.losses.criterion_ms import (
    MSLossConfig,
    batch_losses_ms,
    compute_losses_ms,
    loss_keys_ms,
    row_reductions_ms,
    weighted_total_ms,
)
from flashvtg_tpu_torch.parallel.mesh import batch_world, gather_rows


def declared_loss_keys(loss_cfg):
    """Sorted key order of the train step's loss dict for `loss_cfg`, core
    or _ms (() for None), the weighted total included (JAX
    losses/__init__.py)."""
    if loss_cfg is None:
        return ()
    base = loss_keys_ms(loss_cfg) if isinstance(loss_cfg, MSLossConfig) else loss_keys(loss_cfg)
    return tuple(sorted(base + ("weighted_loss_overall",)))


# what each criterion reads of a forward's outputs after its row
# reductions ("point" is not batch-leading), and of the batch
OUTPUT_READS = ("point", "out_class", "out_coord", "pymid_msk", "video_msk", "nce_sim",
                "saliency_scores", "saliency_scores_neg", "t2vattnvalues", "t2vattnvalues_neg",
                "real_neg_mask")
MS_OUTPUT_READS = ("point", "out_class", "out_coord", "pymid_msk", "video_msk",
                   "saliency_scores", "saliency_scores_neg", "t2vattnvalues",
                   "t2vattnvalues_neg", "real_neg_mask", "sim_score", "slot_att", "eos_slot",
                   "eos_emb", "eos_pos")
TARGET_KEYS = ("saliency_all_labels", "saliency_pos_labels", "saliency_neg_labels",
               "gt_windows")


def global_batch(outputs, targets, reads):
    """(outputs, targets) of the global batch: the keys in `reads` and
    TARGET_KEYS gathered over the ranks (a list of tensors element by
    element), "point" as it is."""

    def gather(v):
        return [gather_rows(x) for x in v] if isinstance(v, (list, tuple)) else gather_rows(v)

    out = {k: outputs[k] if k == "point" else gather(outputs[k])
           for k in reads if k in outputs}
    return out, {k: gather_rows(targets[k]) for k in TARGET_KEYS if k in targets}


def criterion(loss_cfg, outputs, targets):
    """The loss dict of `loss_cfg`'s criterion (core or _ms) on a forward's
    outputs, the weighted total under "weighted_loss_overall"; under a
    split batch the global batch's losses (the module's doc)."""
    ms = isinstance(loss_cfg, MSLossConfig)
    reduce, losses_of, total_of, reads = (
        (row_reductions_ms, batch_losses_ms, weighted_total_ms, MS_OUTPUT_READS) if ms
        else (row_reductions, batch_losses, weighted_total, OUTPUT_READS))
    outputs = {**outputs, **reduce(outputs, targets, loss_cfg)}
    if batch_world() > 1:
        outputs, targets = global_batch(outputs, targets, reads)
    losses = losses_of(outputs, targets, loss_cfg)
    losses["weighted_loss_overall"] = total_of(losses, loss_cfg)
    return losses


__all__ = ["LossConfig", "MSLossConfig", "compute_losses", "compute_losses_ms",
           "criterion", "declared_loss_keys", "loss_keys", "loss_keys_ms",
           "weighted_total", "weighted_total_ms"]
