"""core/weights.py#init_memo: within it init_variables_np hands out copies
of the trees it drew before, bit for bit the trees it would draw, for every
config that agrees on the fields the draw reads."""

import dataclasses

import numpy as np
import pytest

from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import weights

FCFG = FeatureConfig(("rgb", "audio"), (24, 8), True, 10)
SMALL = ModelConfig(netvlad_cluster_size=4, netvlad_hidden_size=8, rvlad_cluster_size=4, fv_cluster_size=4,
                    fv_hidden_size=8, dbof_cluster_size=16, dbof_hidden_size=8, lstm_cells=8, gru_cells=8,
                    attention_hidden_size=8, attention_heads=2, attention_cluster_size=4,
                    transformer_ff_size=8, vocab_size=12)
MODELS = ("NetVLADModelLF", "NetFVModelLF", "DbofModel", "LstmModel", "GruModel", "AttentionPoolingModel",
          "TransformerEncoderModel", "MoeModel")


def flat(tree):
    return weights._flatten(tree)


def assert_same(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name


@pytest.mark.parametrize("model", MODELS)
def test_memo_hands_out_the_draw_for_configs_that_agree_on_what_it_reads(model):
    fcfg = FCFG if model != "MoeModel" else FeatureConfig(("mean_rgb", "mean_audio"), (24, 8), False)
    want = weights.init_variables_np(SMALL, fcfg, seed=3, model_name=model)
    other = dataclasses.replace(SMALL, compute_dtype="bfloat16", fused_train_aggregation=True)
    with weights.init_memo() as memo:
        first = weights.init_variables_np(SMALL, fcfg, seed=3, model_name=model)
        flat(first)[next(iter(flat(first)))][...] = 7.0  # a caller's change stays its own
        again = weights.init_variables_np(other, fcfg, seed=3, model_name=model)
        assert len(memo.entries) == 1
        assert_same(again, want)
        reseeded = weights.init_variables_np(SMALL, fcfg, seed=4, model_name=model)
        assert len(memo.entries) == 2
        assert_same(reseeded, weights._draw_variables_np(SMALL, fcfg, 4, model))
    assert weights._memo is None


def test_memo_draws_again_where_a_read_field_differs_and_drops_the_oldest():
    wider = dataclasses.replace(SMALL, netvlad_cluster_size=6)
    with weights.init_memo(max_bytes=1) as memo:
        weights.init_variables_np(SMALL, FCFG, model_name="NetVLADModelLF")
        got = weights.init_variables_np(wider, FCFG, model_name="NetVLADModelLF")
        assert len(memo.entries) == 1 and memo.entries[0][1]["netvlad_cluster_size"] == 6
    assert_same(got, weights._draw_variables_np(wider, FCFG, 0, "NetVLADModelLF"))
    assert flat(got)["params/NetVLAD_0/cluster_weights"].shape == (32, 6)
