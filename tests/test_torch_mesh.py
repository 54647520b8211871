"""The port's mesh (learnablepoolingmethods_torch/parallel/) against the JAX
package's parallel/mesh.py: create_mesh's layout and its ValueError, the
rows each rank holds (and each microbatch under accumulation), the padding,
the input shards of nodes, the leaves shard_params splits, the draws of a
rank's rows (frames, dropout masks, the fused front end's), and the
collectives' gradients on two gloo ranks (run once, in the module's
fixture)."""

import os

import jax
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.ops import fused_frontend as jff
from learnablepoolingmethods_tpu.parallel import mesh as jmesh
from learnablepoolingmethods_torch import losses
from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.models import create_model, list_models
from learnablepoolingmethods_torch.models.modules import BatchNorm
from learnablepoolingmethods_torch.ops import dropout as tdropout
from learnablepoolingmethods_torch.ops import fused_frontend as tff
from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
from learnablepoolingmethods_torch.utils import prng
from tests import _torch_mesh_oracle as O
from tests import _torch_mp


@pytest.mark.parametrize("model, dcn", [(2, 1), (1, 2), (2, 2), (3, 1)])
def test_one_process_mesh_of_more_than_one_raises_jaxs_value_error(model, dcn):
    with pytest.raises(ValueError) as want:
        jmesh.create_mesh(jax.devices()[:1], model_parallelism=model, dcn_parallelism=dcn)
    with pytest.raises(ValueError) as got:
        mesh_lib.create_mesh(model_parallelism=model, dcn_parallelism=dcn)
    assert str(got.value) == str(want.value)


def test_one_process_mesh_is_one_rank_with_no_groups():
    mesh = mesh_lib.create_mesh()
    assert (mesh.world, mesh.data_size, mesh.model_size, mesh.rank) == (1, 1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    assert mesh.input_shard == (0, 1) and mesh.axis_names == ("data", "model")


@pytest.mark.parametrize("model, dcn", [(1, 1), (2, 1), (4, 1), (2, 2), (1, 2)])
def test_rank_layout_and_rows_follow_jax_device_layout(model, dcn):
    """Rank r sits where device r sits in JAX's mesh of 8 devices, and holds
    the rows that shard_batch places on that device."""
    jm = jmesh.create_mesh(jax.devices()[:8], model_parallelism=model, dcn_parallelism=dcn)
    data = 8 // (model * dcn)
    batch = {"features": np.arange(16 * 3, dtype=np.float32).reshape(16, 3)}
    placed = jmesh.shard_batch(batch, jm)["features"]
    rows_of = {s.device.id: np.asarray(s.data)[:, 0] // 3 for s in placed.addressable_shards}
    for rank in range(8):
        mesh = mesh_lib.Mesh(dcn, data, model, rank, 8)
        assert mesh.axis_names == jm.axis_names
        np.testing.assert_array_equal(mesh.devices, np.vectorize(lambda d: d.id)(jm.devices))
        np.testing.assert_array_equal(mesh.local_rows(16), rows_of[rank])
        assert mesh.row_offset(len(rows_of[rank])) == rows_of[rank][0]


@pytest.mark.parametrize("accum", [2, 4])
def test_microbatch_i_of_each_rank_is_its_share_of_the_global_microbatch_i(accum):
    """The JAX step slices microbatch i out of the global batch; under a
    data mesh of four the ranks' i-th local microbatches cover it in order."""
    n, blocks = 32, 4
    meshes = [mesh_lib.Mesh(1, blocks, 1, r, blocks) for r in range(blocks)]
    local = [m.local_rows(n, accum).reshape(accum, -1) for m in meshes]
    mb = n // accum
    for i in range(accum):
        np.testing.assert_array_equal(np.concatenate([rows[i] for rows in local]), np.arange(i * mb, (i + 1) * mb))
        for m, rows in zip(meshes, local):
            assert rows[i][0] == i * mb + m.row_offset(mb // blocks)


@pytest.mark.parametrize("world, local_world, model, want", [
    (8, 8, 2, [(0, 1)] * 8),                    # one node
    (8, 4, 2, [(0, 2)] * 4 + [(1, 2)] * 4),     # two nodes of four
    (2, 1, 1, [(0, 2), (1, 2)]),                # two nodes of one (the multiprocess test)
    (4, 1, 2, [(0, 2), (0, 2), (1, 2), (1, 2)]),  # a model group over two nodes reads one stream
])
def test_input_shards_of_nodes(world, local_world, model, want):
    got = [mesh_lib.Mesh(1, world // model, model, r, local_world).input_shard for r in range(world)]
    assert got == want
    # the ranks of one model group always hold the same rows
    for r in range(world):
        a, b = mesh_lib.Mesh(1, world // model, model, r, local_world), \
            mesh_lib.Mesh(1, world // model, model, r - r % model, local_world)
        assert a.input_shard == b.input_shard and a.block == b.block


@pytest.mark.parametrize("n, multiple", [(7, 2), (8, 2), (5, 8)])
def test_pad_batch_to_multiple_equals_jax(n, multiple):
    batch = {"features": np.ones((n, 3), np.uint8), "weights": np.ones(n, np.float32),
             "video_id": [b"v%d" % i for i in range(n)]}
    got = mesh_lib.pad_batch_to_multiple(batch, multiple)
    want = jmesh.pad_batch_to_multiple(batch, multiple)
    assert got["video_id"] == want["video_id"]
    for k in ("features", "weights"):
        np.testing.assert_array_equal(got[k], want[k])


def _jax_split(tree, mesh, min_size):
    sharded = jmesh.shard_params(tree, mesh, min_size=min_size)
    return {"/".join(str(k.key) for k in path) for path, leaf in jax.tree_util.tree_leaves_with_path(sharded)
            if any(s == jmesh.MODEL_AXIS for s in leaf.sharding.spec)}


NARROW = dict(vocab_size=16, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=16, fv_cluster_size=4,
              dbow_cluster_size=16, rvlad_cluster_size=8, nextvlad_cluster_size=8, nextvlad_hidden_size=16,
              dbof_cluster_size=32, dbof_hidden_size=16, lstm_cells=8, gru_cells=8, attention_hidden_size=16,
              attention_heads=2, transformer_ff_size=24, attention_cluster_size=3)


@pytest.mark.parametrize("model_name", list_models())
def test_shard_rule_splits_the_leaves_jax_shard_params_splits(model_name):
    """Every registered model at narrow widths, the JAX test's 2⁸ threshold,
    a model axis of 2."""
    frame = model_name not in ("LogisticModel", "MoeModel")
    d = 40 if frame else 20
    batch = {"features": np.zeros((2, 5, d) if frame else (2, d), np.uint8 if frame else np.float32),
             "num_frames": np.full(2, 5, np.int32), "labels": np.zeros((2, 16), np.float32)}
    shapes, _ = jax.eval_shape(
        lambda: jstep.init_model_variables(jcreate(model_name, JModelConfig(**NARROW)), batch, frame, seed=0))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = _jax_split(params, jmesh.create_mesh(jax.devices()[:2], model_parallelism=2), O.MIN_SIZE)
    net = create_model(model_name, ModelConfig(**NARROW), d)
    got = {name.replace(".", "/") for name, p in net.named_parameters()
           if mesh_lib.shard_rule(p.shape, 2, O.MIN_SIZE)}
    assert got == want


def test_willow_width_splits_the_hidden_fc_and_the_moe_kernels():
    """At the default threshold (2²²) and Willow width: the hidden FC
    (278,528 × 1024) and the MoE gate and expert kernels (1024 × 11,586 and
    1024 × 7,724)."""
    with torch.device("meta"):
        net = create_model("NetVLADModelLF", ModelConfig(), 1152)
    got = {name: tuple(p.shape) for name, p in net.named_parameters() if mesh_lib.shard_rule(p.shape, 2)}
    assert got == {"hidden1_weights": (278528, 1024), "MoeModel_0.gates_kernel": (1024, 11586),
                   "MoeModel_0.experts_kernel": (1024, 7724)}


def test_a_ranks_frames_are_its_rows_of_the_global_draw():
    """The rows r0 … of the JAX package's frame draw over the whole batch."""
    key = prng.key(5)
    nf = np.array([3, 9, 12, 1, 7, 12, 5, 2], np.int32)
    want = np.asarray(jff.sample_indices(jax.random.key(5), jax.numpy.asarray(nf), 12, 6))
    for r0 in (0, 4, 6):
        got = tff.sample_indices(key, torch.from_numpy(nf[r0:]), 12, 6, row_offset=r0)
        np.testing.assert_array_equal(got.numpy(), want[r0:])


def test_a_ranks_dropout_mask_is_its_rows_of_the_global_mask():
    key = prng.key(3)
    whole = tdropout.keep_mask(key, 0.7, (8, 5, 4))
    x = torch.ones(3, 5, 4)
    got = tdropout.dropout(x, key, 0.3, row_offset=4)
    np.testing.assert_array_equal((got != 0).numpy(), whole[4:7].numpy())
    # a mask shared by the rows takes no offset
    w = torch.ones(3, 2, 5, 5)
    shared = tdropout.dropout(w, key, 0.3, (1, 1, 5, 5), mode="mul", row_offset=4)
    np.testing.assert_array_equal((shared != 0).numpy()[0, 0], tdropout.keep_mask(key, 0.7, (5, 5)).numpy())


@pytest.mark.parametrize("use_remat", [False, True])
def test_the_train_steps_row_offset_keys_the_transformers_dropout(use_remat):
    """TrainStep.forward hands its row offset to a model that takes a
    dropout key, under remat too, and the encoder then drops a rank's rows
    of the global masks."""
    cfg = ModelConfig(attention_hidden_size=8, attention_heads=2, transformer_ff_size=16,
                      transformer_layers=2, attention_dropout=0.5)
    model = create_model("TransformerEncoderModel", cfg, 6)
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.5
    key = prng.key(7)
    x, mask = torch.randn(8, 5, 8, generator=gen), torch.ones(8, 5, dtype=torch.bool)
    whole = model.encoder(x, mask, key)
    torch.testing.assert_close(model.encoder(x[4:], mask[4:], key, row_offset=4), whole[4:],
                               rtol=1e-6, atol=1e-6)
    assert not torch.allclose(model.encoder(x[4:], mask[4:], key), whole[4:])
    seen, forward = [], model.forward
    model.forward = lambda *a, **k: (seen.append(k.get("row_offset")), forward(*a, **k))[1]
    step = tstep.TrainStep(losses.CrossEntropyLoss(), TrainingConfig(use_remat=use_remat), cfg, True)
    out = step.forward(model, torch.randn(4, 5, 6, generator=gen), torch.full((4,), 5), key, row_offset=4)
    assert seen and set(seen) == {4} and out["predictions"].shape == (4, cfg.vocab_size)


def test_the_fused_front_ends_plain_version_draws_a_ranks_rows():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, size=(6, 10, 1152), dtype=np.uint8))
    nf = torch.from_numpy(rng.integers(1, 11, size=6).astype(np.int32))
    consts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in
              [(1152,), (1152,), (1024, 8), (8,), (8,), (1024, 8), (128, 4), (4,), (4,), (128, 4)]]
    key = prng.key(2)
    whole = tff.netvlad_frontend(x, key, nf, 5, *consts)
    part = tff.netvlad_frontend(x[3:], key, nf[3:], 5, *consts, row_offset=3)
    for a, b in zip(whole, part):
        torch.testing.assert_close(a[3:], b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    root = O.out_dir(tmp_path_factory, "collectives")
    _torch_mp.spawn(2, [{"fn": "collectives", "kw": {"out": root, "name": "c"}}])
    return [np.load(os.path.join(root, f"c_{r}.npz")) for r in (0, 1)]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    rows = torch.from_numpy(rng.normal(size=(2, 4, 3)).astype(np.float32))
    return x, w, rows


def test_column_parallel_product_and_its_gradients(collectives):
    x, w, _ = _inputs()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = x @ w
    (y * (torch.arange(48, dtype=torch.float32).reshape(6, 8) / 48)).sum().backward()
    for r, got in enumerate(collectives):
        np.testing.assert_allclose(got["mm_y"], y.detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["mm_dx"], x.grad.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["mm_dw"], w.grad.numpy()[:, 4 * r:4 * (r + 1)], rtol=1e-6)


def test_gathered_parameters_gradient_is_the_ranks_columns(collectives):
    x, w, _ = _inputs()
    w.requires_grad_(True)
    ((x @ w) ** 2).sum().backward()
    for r, got in enumerate(collectives):
        np.testing.assert_allclose(got["full_dw"], w.grad.numpy()[:, 4 * r:4 * (r + 1)], rtol=1e-5)


def test_all_reduce_sum_backward_sums_the_ranks_cotangents(collectives):
    for r, got in enumerate(collectives):
        np.testing.assert_array_equal(got["ar_dv"], np.full(3, 3.0 * (r + 1)))


def test_batch_norm_over_the_data_group_is_the_whole_batchs(collectives):
    _, _, rows = _inputs()
    bn = BatchNorm(3)
    x = rows.reshape(8, 3).clone().requires_grad_(True)
    y = bn(x, training=True)
    (y * torch.arange(12, dtype=torch.float32).reshape(4, 3).repeat(2, 1)).sum().backward()
    for r, got in enumerate(collectives):
        np.testing.assert_allclose(got["bn_y"], y.detach().numpy()[4 * r:4 * (r + 1)], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["bn_dx"], x.grad.numpy()[4 * r:4 * (r + 1)], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["bn_mean"], bn.mean.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["bn_var"], bn.var.numpy(), rtol=1e-6)
    np.testing.assert_allclose(collectives[0]["bn_dscale"] + collectives[1]["bn_dscale"], bn.scale.grad.numpy(),
                               rtol=1e-5)
