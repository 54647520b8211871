"""ops/metrics_ops.py#batch_topk_partials ≡ the JAX package's, exact in
f32, on random batches with padding rows, tied scores, rows without labels
and k past the vocabulary; without ties the default accumulator's GAP equals
--fast_eval's; and core/observability.py#MetricWriter writes the
reference's scalar names, or only logs."""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import metrics_ops as jmetrics
from learnablepoolingmethods_torch.core.observability import MetricWriter
from learnablepoolingmethods_torch.metrics import eval_util
from learnablepoolingmethods_torch.ops import metrics_ops

# (batch, vocabulary, top_k, padding rows, rows without labels, tied scores)
CASES = {
    "plain": (8, 50, 20, 0, 0, False),
    "padding": (8, 50, 20, 3, 0, False),
    "ties": (6, 40, 10, 1, 0, True),
    "no_labels": (7, 30, 5, 2, 3, False),
    "k_past_vocab": (4, 12, 20, 1, 1, True),
    "perr_bound": (3, 300, 20, 0, 0, True),
}


def _inputs(b, v, pad, empty, ties, seed):
    rng = np.random.default_rng(seed)
    preds = rng.random((b, v)).astype(np.float32)
    if ties:
        # a few distinct values, so that top-k and PERR meet ties
        preds = np.round(preds * 4) / 4
    labels = (rng.random((b, v)) < 0.2).astype(np.float32)
    if v > 256:
        labels[0, :] = 1.0  # more labels than PERR's bound
    labels[b - pad - empty:b - pad] = 0.0
    weights = np.r_[np.ones(b - pad), np.zeros(pad)].astype(np.float32)
    return preds, labels, weights


@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_jax_exactly(case):
    b, v, k, pad, empty, ties = CASES[case]
    preds, labels, weights = _inputs(b, v, pad, empty, ties, seed=len(case))
    want = jmetrics.batch_topk_partials(jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(weights),
                                        top_k=k)
    got = metrics_ops.batch_topk_partials(torch.from_numpy(preds), torch.from_numpy(labels),
                                          torch.from_numpy(weights), top_k=k)
    for field in jmetrics.BatchMetricPartials._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_partials_without_weights_count_every_row():
    preds, labels, _ = _inputs(5, 20, 0, 1, False, seed=1)
    got = metrics_ops.batch_topk_partials(torch.from_numpy(preds), torch.from_numpy(labels), top_k=4)
    want = jmetrics.batch_topk_partials(jnp.asarray(preds), jnp.asarray(labels), top_k=4)
    assert float(got.weight_sum) == 5.0
    for field in jmetrics.BatchMetricPartials._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(want, field)))


@pytest.mark.parametrize("videos", [50, 200, 800])
def test_default_accumulator_agrees_with_fast_eval_without_ties(videos):
    """Three batches, V=3862, distinct f32 scores (no ties), a few labels a
    video, most ranked first: the default accumulator's GAP, summed in float64,
    equals StreamingGAP's over the device partials within 1e-12.  Summed in
    float32 (1.0 over a float32 count under NumPy 2) it parted from it by
    1e-8 to 5e-7 here, more as the pool grows."""
    rng = np.random.default_rng(videos)
    labels = (rng.random((videos, 3862)) < 1e-3).astype(np.float32)
    labels[np.arange(videos), rng.integers(0, 3862, videos)] = 1.0
    # distinct ranks: the positives take p of the 2p highest at random
    pos, n = labels.ravel() > 0, labels.size
    ranks = np.empty(n)
    ranks[pos] = n - 1 - rng.choice(2 * pos.sum(), pos.sum(), replace=False)
    ranks[~pos] = rng.permutation(np.setdiff1d(np.arange(n), ranks[pos]))
    probs = ((ranks.reshape(labels.shape) + 0.5) / n).astype(np.float32)
    em, fast = eval_util.EvaluationMetrics(3862, 20), eval_util.StreamingGAP()
    for rows in np.array_split(np.arange(videos), 3):
        em.accumulate(probs[rows], labels[rows], 0.0)
        p = metrics_ops.batch_topk_partials(torch.from_numpy(probs[rows]), torch.from_numpy(labels[rows]))
        fast.accumulate(p.topk_scores.numpy(), p.topk_labels.numpy(), float(p.num_positives))
    assert np.unique(probs).size == probs.size
    assert abs(float(em.get()["gap"]) - fast.get()) <= 1e-12


def test_metric_writer_writes_the_reference_names(tmp_path):
    writer = MetricWriter(str(tmp_path / "eval"))
    info = {"avg_hit_at_one": 0.5, "avg_perr": 0.25, "avg_loss": 3.0, "gap": 0.125, "aps": [0.1, 0.3]}
    writer.epoch_summary(2, info)
    writer.global_step_summary(3, 0.5, 0.25, 0.125, 3.0, 100.0)
    writer.flush()
    writer.close()
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (events,) = glob.glob(str(tmp_path / "eval" / "events.out.tfevents.*"))
    acc = EventAccumulator(events)
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}
    assert scalars["model/Eval_GAP"] == [(2, 0.125)]
    assert scalars["model/Eval_MAP"] == [(2, pytest.approx(0.2))]
    assert scalars["model/Training_Hit@1"] == [(3, 0.5)]
    assert {"model/Eval_Hit@1", "model/Eval_Perr", "model/Eval_Loss", "model/Training_Perr",
            "model/Training_GAP", "model/loss", "global_step/Examples/Second"} <= set(scalars)


def test_metric_writer_without_a_logdir_only_logs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    writer = MetricWriter("")
    writer.epoch_summary(0, {"avg_hit_at_one": 1, "avg_perr": 1, "avg_loss": 0, "gap": 1, "aps": None})
    writer.flush()
    writer.close()
    assert not list(tmp_path.iterdir())
