"""The port's data axis on two gloo ranks of the CPU against the JAX
package's steps on a 2-device data mesh (the cases of
tests/distributed/test_dp_equivalence.py): the sharded train step on
MoeModel and on a narrow NetVLADModelLF with BatchNorm, whose batches end in
padded rows so that the ranks' Σw differ; gradient accumulation and remat;
the eval step's predictions, loss and partials; and the eval CLI over two
ranks against one process.  The two ranks run once, in the module's fixture,
every case in turn."""

import json
import os

import numpy as np
import pytest

from learnablepoolingmethods_torch import eval as teval
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core.weights import init_variables_np, save_variables_npz
from learnablepoolingmethods_torch.data import fixtures
from tests import _torch_mesh_oracle as O
from tests import _torch_mp

ACCUM = dict(O.TCFG, batch_size=16, grad_accum_steps=4)
REMAT = dict(O.TCFG, use_remat=True, grad_accum_steps=2)
EVAL_FLAGS = ["--model=LogisticModel", "--feature_names=mean_rgb,mean_audio", "--feature_sizes=1024,128",
              "--num_classes=16", "--batch_size=8", "--run_once", "--device=cpu", "--top_k=5"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = O.out_dir(tmp_path_factory, "dp")
    rng = np.random.default_rng(0)
    moe = [O.moe_batch(rng)]
    # 7 real rows padded to 8: rank 0 holds 4 real rows, rank 1 3 and a pad
    vlad = [O.netvlad_batch(rng, b=7), O.netvlad_batch(rng, b=7, real=5)]
    vlad8 = [O.netvlad_batch(rng)]
    cases = {}
    for name, case, batches, tcfg in (("moe", O.MOE, moe, O.TCFG), ("vlad", O.NETVLAD, vlad, O.TCFG),
                                      ("accum", O.MOE, moe, ACCUM), ("remat", O.NETVLAD, vlad8, REMAT)):
        init_path = os.path.join(root, f"{name}_init.npz")
        init = O.write_init(case, batches[0], init_path)
        kw = dict(out=root, name=name, model_name=case["model_name"], mcfg=O.port_mcfg(case), tcfg=tcfg,
                  frame_features=case["frame_features"], input_size=case["input_size"], init=init_path,
                  batches=O.write_batches(batches, os.path.join(root, f"{name}_batches.npz")))
        cases[name] = (case, init, batches, tcfg, kw)
    eval_batch = O.netvlad_batch(rng, b=7)
    np.savez(os.path.join(root, "eval_batch.npz"), **eval_batch)
    # the eval CLI: a video-level fixture of 20 videos, batches of 8 (the
    # last one 4 rows, padded on the two ranks to 4 and split 2 + 2)
    data = os.path.join(root, "videos-0.tfrecord")
    fixtures.write_video_level_fixture(data, 20, num_classes=16, seed=3)
    mcfg = ModelConfig(vocab_size=16)
    weights = os.path.join(root, "weights")
    os.makedirs(weights)
    save_variables_npz(init_variables_np(mcfg, FeatureConfig(), seed=2, model_name="LogisticModel"), weights)
    eval_argv = EVAL_FLAGS + [f"--eval_data_pattern={data}", f"--train_dir={weights}"]
    jobs = [{"fn": "train_steps", "kw": c[-1]} for c in cases.values()]
    jobs.append({"fn": "eval_forward", "kw": dict(
        out=root, name="eval", model_name="NetVLADModelLF", mcfg=O.port_mcfg(O.NETVLAD), frame_features=True,
        input_size=24, init=cases["vlad"][-1]["init"], batch=os.path.join(root, "eval_batch.npz"))})
    jobs.append({"fn": "cli", "kw": dict(out=root, name="eval_cli", module="eval", argv=eval_argv + ["--fast_eval"])})
    jobs.append({"fn": "cli", "kw": dict(out=root, name="eval_cli_em", module="eval", argv=eval_argv)})
    _torch_mp.spawn(2, jobs)
    return root, cases, eval_batch, eval_argv


@pytest.mark.parametrize("name", ["moe", "vlad", "accum", "remat"])
def test_two_rank_train_step_equals_jax_on_a_two_device_data_mesh(run, name):
    root, cases, _, _ = run
    case, init, batches, tcfg, _ = cases[name]
    got = np.load(os.path.join(root, f"{name}.npz"))
    losses, want, preds = O.jax_train(case, init, batches, tcfg=tcfg, devices=2)
    np.testing.assert_allclose(got["losses"], losses, rtol=O.RTOL)
    O.assert_state_close(got, want)
    # the log step's predictions: the node's rows, in the batch's order
    np.testing.assert_allclose(got[f"preds{len(batches) - 1}"], preds, rtol=O.RTOL, atol=O.ATOL)


def test_padded_rows_with_uneven_weights_reach_the_ranks_unevenly(run):
    """Non-vacuity of the padded case: the ranks' Σw differ (4 and 3), and
    the BN statistics moved."""
    _, cases, _, _ = run
    batches = cases["vlad"][2]
    w = np.r_[batches[0]["weights"], 0.0]
    assert w[:4].sum() == 4 and w[4:].sum() == 3
    got = np.load(os.path.join(run[0], "vlad.npz"))
    assert not np.allclose(got["state/batch_stats/input_bn/mean"], 0.0)


def test_two_rank_eval_partials_equal_jax(run):
    root, cases, batch, _ = run
    got = np.load(os.path.join(root, "eval.npz"))
    want = O.jax_eval(O.NETVLAD, cases["vlad"][1], batch, devices=2)
    np.testing.assert_allclose(got["predictions"], np.asarray(want["predictions"]), rtol=O.RTOL, atol=O.ATOL)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=O.RTOL)
    p = want["partials"]
    np.testing.assert_allclose(got["topk_scores"], np.asarray(p.topk_scores), rtol=O.RTOL, atol=O.ATOL)
    np.testing.assert_array_equal(got["topk_labels"], np.asarray(p.topk_labels))
    for field in ("num_positives", "hit_at_one_sum", "perr_sum"):
        np.testing.assert_allclose(got[field], float(getattr(p, field)), rtol=1e-6, err_msg=field)


@pytest.mark.parametrize("name, flags", [("eval_cli", ["--fast_eval"]), ("eval_cli_em", [])])
def test_eval_cli_over_two_ranks_equals_one_process(run, name, flags):
    """Rank 0 reports the one-process CLI's scores; rank 1 none."""
    root, _, _, argv = run
    with open(os.path.join(root, f"{name}_0.json")) as f:
        got = json.load(f)
    want = teval.main(argv + flags)
    for key in ("gap", "avg_hit_at_one", "avg_perr", "avg_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    with open(os.path.join(root, f"{name}_1.json")) as f:
        assert json.load(f) is None
