"""Port span ops, anchor points, pyramid masks, NMS and the synthetic-set
writer vs their JAX counterparts, on the CPU. Each is held to equality
(float32 elementwise math in the same order) or, where a float op order may
differ, to 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's share of the cores under xdist)
import torch

from flashvtg_tpu.models import points as jpoints
from flashvtg_tpu.models.components import pool_mask as jax_pool_mask
from flashvtg_tpu.ops import nms as jnms
from flashvtg_tpu.ops import span as jspan
from flashvtg_tpu.utils.synthetic import make_synthetic_qvh as jax_synth
from flashvtg_tpu_torch.models import points
from flashvtg_tpu_torch.models.components import pool_mask
from flashvtg_tpu_torch.ops import nms, span
from flashvtg_tpu_torch.ops.pad import bucket_length, pad_batch
from flashvtg_tpu.ops.pad import bucket_length as jax_bucket_length
from flashvtg_tpu.ops.pad import pad_batch as jax_pad_batch
from flashvtg_tpu_torch.utils.synthetic import make_synthetic_qvh


def _spans(rng, shape):
    st = rng.uniform(0, 100, shape).astype(np.float32)
    return np.stack([st, st + rng.uniform(0.5, 30, shape).astype(np.float32)], -1)


@pytest.mark.parametrize(
    "name",
    ["span_xx_to_cxw", "span_cxw_to_xx", "temporal_iou", "generalized_temporal_iou"],
)
def test_span_ops_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = _spans(rng, (3, 7)), _spans(rng, (3, 5))
    fj, ft = getattr(jspan, name), getattr(span, name)
    if name.startswith("span_"):
        ref, ours = fj(jnp.asarray(a)), ft(torch.from_numpy(a))
    else:
        ref = fj(jnp.asarray(a), jnp.asarray(b))
        ours = ft(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("length", [1, 2, 5, 16, 75, 150])
@pytest.mark.parametrize("strides", [(1, 2, 4, 8), (1, 2, 4, 8, 16), (1,)])
def test_points_and_level_sizes_match_jax(length, strides):
    assert points.pyramid_level_sizes(length, strides) == jpoints.pyramid_level_sizes(
        length, strides
    )
    np.testing.assert_array_equal(
        points.generate_points(length, strides), jpoints.generate_points(length, strides)
    )


def test_pyramid_masks_match_jax():
    rng = np.random.default_rng(1)
    lens = rng.integers(1, 76, 20)
    lens[:4] = (1, 2, 3, 75)
    strides = (1, 2, 4, 8)
    ours = points.pyramid_masks_strict(lens, 75, strides)
    ref = jpoints.pyramid_masks_strict(lens, 75, strides)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    mask = (np.arange(75)[None] < lens[:, None]).astype(np.float32)
    for o, r in zip(
        points.pyramid_masks_pool(torch.from_numpy(mask), strides),
        jpoints.pyramid_masks_pool(jnp.asarray(mask), strides),
    ):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for s in strides:
        np.testing.assert_array_equal(
            pool_mask(torch.from_numpy(mask), s).numpy(),
            np.asarray(jax_pool_mask(jnp.asarray(mask), s)),
        )


def _nms_inputs(seed):
    rng = np.random.default_rng(seed)
    spans = _spans(rng, (6, 50))
    # snap to a 2 s grid so that identical windows and IoU ties occur
    spans = np.round(spans / 2) * 2
    scores = np.round(rng.uniform(0, 1, (6, 50)), 2).astype(np.float32)
    scores[0, :10] = 0.5  # tied scores
    scores[1, 5:] = 0.0  # already-suppressed windows
    return spans.astype(np.float32), scores


@pytest.mark.parametrize("nms_type", ["normal", "linear"])
@pytest.mark.parametrize("thd", [0.3, 0.7])
def test_suppress_overlaps_matches_jax(nms_type, thd):
    spans, scores = _nms_inputs(2)
    spans[2, 3] = spans[2, 4]  # a duplicated window
    ref_s, ref_sc = jnms.suppress_overlaps(
        jnp.asarray(spans), jnp.asarray(scores), thd, nms_type
    )
    ours_s, ours_sc = nms.suppress_overlaps(
        torch.from_numpy(spans), torch.from_numpy(scores), thd, nms_type
    )
    np.testing.assert_array_equal(ours_s.numpy(), np.asarray(ref_s))
    np.testing.assert_allclose(ours_sc.numpy(), np.asarray(ref_sc), atol=1e-6)
    if nms_type == "normal":
        assert (ours_sc.numpy() == 0).sum() > (scores == 0).sum()


def test_nms_rejects_unknown_type():
    spans, scores = _nms_inputs(3)
    with pytest.raises(ValueError):
        nms.suppress_overlaps(torch.from_numpy(spans), torch.from_numpy(scores), 0.5, "soft")


def test_padding_helpers_match_jax():
    rng = np.random.default_rng(4)
    seqs = [rng.standard_normal((n, 3)).astype(np.float32) for n in (4, 9, 1)]
    for o, r in zip(pad_batch(seqs, 8), jax_pad_batch(seqs, 8)):
        np.testing.assert_array_equal(o, r)
    for n in (1, 75, 76, 5000):
        assert bucket_length(n) == jax_bucket_length(n)


def test_synthetic_set_matches_jax_copy(tmp_path):
    ours = make_synthetic_qvh(str(tmp_path / "a"), n_queries=5)
    ref = jax_synth(str(tmp_path / "b"), n_queries=5)
    assert open(ours[0]).read() == open(ref[0]).read()
    for d_ours, d_ref in zip(ours[1:], ref[1:]):
        names = sorted(os.listdir(d_ref))
        assert sorted(os.listdir(d_ours)) == names
        for name in names:
            a, b = np.load(os.path.join(d_ours, name)), np.load(os.path.join(d_ref, name))
            for key in b.files:
                np.testing.assert_array_equal(a[key], b[key])
