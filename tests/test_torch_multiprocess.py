"""The train CLI under two simulated nodes (``LOCAL_WORLD_SIZE=1`` each, two
gloo ranks), the cases of tests/distributed/test_multiprocess.py and
test_crash_resume_mp.py:

- node 0 builds the packed cache while node 1 waits for it
  (``packed_cache.wait_for_cache``), and each node reads its own shard;
- both ranks end with the same state and log the same global loss, and the
  run equals one process stepping through the global batches (the two
  nodes' batches one after the other);
- a run whose rank 1 dies by SIGKILL right after step 3's checkpoint leaves
  step 3 the latest, and a restart resumes both ranks from it (the batch
  iterator starts again, as the train CLI's does) to what one process
  replaying the same batches reaches.

Each launch runs the two ranks once; three launches in all."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from learnablepoolingmethods_torch import train
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager
from learnablepoolingmethods_torch.core.step import TrainStep
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.core.weights import init_variables_np, load_flax_variables
from learnablepoolingmethods_torch.data import fixtures, packed_cache
from learnablepoolingmethods_torch.losses import get_loss_by_name
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.utils import prng
from tests import _torch_mesh_oracle as O
from tests import _torch_mp

CRASH_AT, STEPS, NODE_BATCH = 3, 5, 4
FLAGS = ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio", "--feature_sizes=8,4",
         "--max_frames=5", "--num_classes=6", "--netvlad_cluster_size=4", "--netvlad_hidden_size=8",
         "--iterations=3", f"--batch_size={NODE_BATCH}", "--device=cpu", "--seed=3", "--log_every_n_steps=1",
         "--save_checkpoint_every_n_steps=1", f"--max_steps={STEPS}"]


def _job(root, name, train_dir, crash_at=0):
    argv = FLAGS + [f"--train_data_pattern={root}/train-0.tfrecord", f"--train_dir={train_dir}",
                    f"--packed_cache_dir={root}/cache"]
    return [{"fn": "cli", "kw": dict(out=root, name=name, module="train", argv=argv, crash_at=crash_at)}]


def _load(root, name, rank):
    with open(os.path.join(root, f"{name}_{rank}.json")) as f:
        return json.load(f), np.load(os.path.join(root, f"{name}_{rank}.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = O.out_dir(tmp_path_factory, "mp")
    fixtures.write_frame_level_fixture(os.path.join(root, "train-0.tfrecord"), 16, num_classes=6, rgb_size=8,
                                       audio_size=4, max_frames=5, seed=11)
    # the whole run; node 1 waits for the cache that node 0 builds
    _torch_mp.spawn(2, _job(root, "whole", os.path.join(root, "whole")), local_world=1)
    # rank 1 dies right after step CRASH_AT's checkpoint is in place; rank 0,
    # stuck in the next step's collectives or failing out of them, is torn
    # down, as a launcher tears down the job
    argv = [os.path.abspath(_torch_mp.__file__),
            json.dumps(_job(root, "crash", os.path.join(root, "crash"), crash_at=CRASH_AT))]
    procs = _torch_mp.launch(2, argv, local_world=1)
    _, err1 = procs[1].communicate(timeout=300)
    assert procs[1].returncode == -signal.SIGKILL, err1[-4000:]
    procs[0].kill()
    procs[0].communicate(timeout=60)
    steps_after_crash = sorted(os.listdir(os.path.join(root, "crash", "checkpoints")))
    _torch_mp.spawn(2, _job(root, "resumed", os.path.join(root, "crash")), local_world=1)
    return root, steps_after_crash


def _replay(root, batch_order):
    """One process of the port through the global batches ``batch_order``
    (indices of the nodes' streams): node 0's batch, then node 1's."""
    args = train.build_parser().parse_args(FLAGS + [f"--train_data_pattern={root}/train-0.tfrecord"])
    fcfg, mcfg, tcfg = train.configs_from_args(args)
    streams = [list(packed_cache.packed_batch_iterator(os.path.join(root, "cache"), NODE_BATCH,
                                                       num_epochs=tcfg.num_epochs, shuffle=True, seed=3,
                                                       shard_index=i, num_shards=2))
               for i in (0, 1)]
    model = create_model(args.model, mcfg, fcfg.total_size)
    load_flax_variables(model, init_variables_np(mcfg, fcfg, seed=3, model_name=args.model))
    state = TrainState.create(model, tcfg)
    step = TrainStep(get_loss_by_name(tcfg.label_loss), tcfg, mcfg, True)
    losses = []
    for i in batch_order:
        batch = {k: torch.from_numpy(np.concatenate([streams[0][i][k], streams[1][i][k]]))
                 for k in streams[0][i] if k != "video_id"}
        losses.append(float(step(state, batch, prng.key(3))["loss"]))
    return losses, {k: v.detach().numpy() for k, v in state.state_tree().items()}


def test_node_1_waited_for_the_cache_node_0_built(runs):
    root, _ = runs
    assert packed_cache.is_fresh(os.path.join(root, "cache"), os.path.join(root, "train-0.tfrecord"))


def test_the_nodes_shards_partition_the_videos(runs):
    """Non-vacuity: the two nodes' streams are disjoint and cover the set."""
    root, _ = runs
    ids = [{v for b in packed_cache.packed_batch_iterator(os.path.join(root, "cache"), NODE_BATCH, num_epochs=1,
                                                          shard_index=i, num_shards=2) for v in b["video_id"]}
           for i in (0, 1)]
    assert not ids[0] & ids[1] and len(ids[0] | ids[1]) == 16


def test_two_nodes_end_equal_and_log_the_same_global_loss(runs):
    root, _ = runs
    (h0, s0), (h1, s1) = _load(root, "whole", 0), _load(root, "whole", 1)
    assert [h["loss"] for h in h0["history"]] == [h["loss"] for h in h1["history"]]
    assert len(h0["history"]) == STEPS
    assert set(s0.files) == set(s1.files)
    for name in s0.files:
        np.testing.assert_array_equal(s0[name], s1[name], err_msg=name)


def test_two_nodes_equal_one_process_replaying_the_global_batches(runs):
    root, _ = runs
    history, got = _load(root, "whole", 0)
    losses, want = _replay(root, range(STEPS))
    np.testing.assert_allclose([h["loss"] for h in history["history"]], losses, rtol=O.RTOL)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=O.RTOL, atol=O.ATOL, err_msg=name)
    # the rank's final checkpoint is its state
    mngr = CheckpointManager(os.path.join(root, "whole"))
    assert mngr.latest_step() == STEPS


def test_the_crash_leaves_step_3_the_latest_and_nothing_torn(runs):
    _, steps = runs
    assert steps == [str(s) for s in range(1, CRASH_AT + 1)], steps


def test_the_restart_resumes_both_ranks_from_step_3(runs):
    root, _ = runs
    for rank in (0, 1):
        history, _ = _load(root, "resumed", rank)
        assert history["restored_step"] == CRASH_AT
        assert [h["step"] for h in history["history"]] == list(range(CRASH_AT + 1, STEPS + 1))
    # the iterator starts again: steps 4 and 5 train the nodes' batches 0 and 1
    history, got = _load(root, "resumed", 0)
    losses, want = _replay(root, [0, 1, 2, 0, 1])
    np.testing.assert_allclose([h["loss"] for h in history["history"]], losses[CRASH_AT:], rtol=O.RTOL)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=O.RTOL, atol=O.ATOL, err_msg=name)
