"""The train CLI end to end for the attention family and the RNNs, each
checkpoint read back by the eval CLI and the model-forward inference CLI
(the last batch padded with videos of no frames); --fast_infer serves the
trained transformers and refuses the models the JAX package has no fast
path for, as its CLI does."""

import numpy as np
import pytest

from learnablepoolingmethods_torch import eval as eval_cli
from learnablepoolingmethods_torch import inference, train
from learnablepoolingmethods_torch.data import fixtures

V, F = 20, 8
MODELS = ("TransformerEncoderModel", "AttentionPoolingModel", "AttentionNetVLADModel", "LstmModel", "GruModel")
FLAGS = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,128", f"--num_classes={V}",
         f"--max_frames={F}", "--attention_hidden_size=16", "--attention_heads=2", "--transformer_ff_size=24",
         "--attention_cluster_size=3", "--netvlad_cluster_size=4", "--netvlad_hidden_size=12",
         "--lstm_cells=8", "--gru_cells=8", "--device=cpu"]
FAST = ("TransformerEncoderModel", "AttentionNetVLADModel")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("attn_rnn_cli") / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(path, 6, num_classes=V, max_frames=F, seed=3)
    return path


@pytest.mark.parametrize("model", MODELS)
def test_train_eval_and_inference_clis(data, tmp_path, model):
    flags = FLAGS + [f"--model={model}"]
    train_dir = str(tmp_path / "m")
    trainer = train.main(flags + [f"--train_data_pattern={data}", f"--train_dir={train_dir}", "--batch_size=3",
                                  "--max_steps=2", "--log_every_n_steps=1", "--start_new_model"])
    losses = [h["loss"] for h in trainer.history]
    assert trainer.state.step == 2 and len(losses) == 2 and np.isfinite(losses).all()

    info = eval_cli.main(flags + ["--run_once", f"--eval_data_pattern={data}", f"--train_dir={train_dir}",
                                  "--batch_size=4"])
    assert np.isfinite(float(info["gap"])) and np.isfinite(float(info["avg_loss"]))

    out = str(tmp_path / "p.csv")
    args = flags + [f"--input_data_pattern={data}", f"--train_dir={train_dir}", f"--output_file={out}",
                    "--batch_size=4", "--top_k=5"]
    assert inference.main(args) == 6
    rows = open(out).read().splitlines()
    assert rows[0] == "VideoId,LabelConfidencePairs" and len(rows) == 7
    scores = [float(v) for r in rows[1:] for v in r.split(",")[1].split()[1::2]]
    assert np.isfinite(scores).all()
    if model in FAST:
        assert inference.main(args + ["--fast_infer", f"--output_file={tmp_path}/fast.csv"]) == 6
    else:
        with pytest.raises(ValueError, match="--fast_infer supports"):
            inference.main(args + ["--fast_infer"])
