"""Write the small TF1 checkpoint on which the port's ``--reference_checkpoint``
path is checked where tensorflow is absent (``chip_smoke.py``) and here
(``tests/test_torch_checkpoint_import.py``).

NetVLADModelLF at rgb 16 + audio 8 features, 4 clusters, hidden 8 and 12
classes (``FIXTURE_FLAGS``), its weights from
``core/weights.py#init_variables_np(seed=5)`` with the BN statistics drawn
off their initial values, written under the reference's variable names
(``core/checkpoint_import.py#export_reference_layout``) by
``tf.compat.v1.train.Saver`` inside ``variable_scope("tower")`` with an
int64 ``global_step`` of 7, as the reference trainer saves: a V2 bundle of
about 7 KB and its ``checkpoint`` state file in ``tests/data/tf_bundle_netvlad/``.

    python tools/torch_make_tf_bundle_fixture.py [out_dir]

Needs tensorflow, so it runs on a development machine, not on the card's.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "tf_bundle_netvlad")
FIXTURE_STEP = 7
# the model flags of the CLIs that read the fixture
FIXTURE_FLAGS = ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                 "--feature_sizes=16,8", "--num_classes=12", "--netvlad_cluster_size=4",
                 "--netvlad_hidden_size=8", "--iterations=5", "--max_frames=20"]


def fixture_tree() -> dict:
    """The fixture's flax ``{params, batch_stats}`` tree."""
    from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
    from learnablepoolingmethods_torch.core.weights import init_variables_np, tree_paths, unflatten_tree

    mcfg = ModelConfig(vocab_size=12, netvlad_cluster_size=4, netvlad_hidden_size=8, iterations=5)
    fcfg = FeatureConfig(("rgb", "audio"), (16, 8), True, 20)
    tree = init_variables_np(mcfg, fcfg, seed=5, model_name="NetVLADModelLF")
    rng = np.random.default_rng(5)
    flat = tree_paths(tree)
    for name, value in flat.items():
        if name.startswith("batch_stats/"):
            flat[name] = (value + 0.1 * np.abs(rng.normal(size=value.shape))).astype(np.float32)
        elif name.endswith("experts_bias"):
            flat[name] = rng.normal(scale=0.5, size=value.shape).astype(np.float32)
    return unflatten_tree(flat)


def write(out_dir: str = FIXTURE_DIR) -> str:
    """Write the bundle into ``out_dir``; returns its prefix."""
    import tensorflow as tf

    from learnablepoolingmethods_torch.core.checkpoint_import import export_reference_layout

    tree = fixture_tree()
    ref = export_reference_layout(tree["params"], tree["batch_stats"], vocab=12)
    os.makedirs(out_dir, exist_ok=True)
    graph = tf.Graph()
    with graph.as_default():
        with tf.compat.v1.variable_scope("tower"):
            for name, value in sorted(ref.items()):
                tf.compat.v1.get_variable(name, initializer=tf.constant(value))
        step = tf.compat.v1.train.get_or_create_global_step()
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            sess.run(step.assign(FIXTURE_STEP))
            prefix = saver.save(sess, os.path.join(out_dir, "model.ckpt"), global_step=FIXTURE_STEP,
                                write_meta_graph=False, write_state=False)
    # the state file as the Saver writes it, with the path relative to it
    with open(os.path.join(out_dir, "checkpoint"), "w") as f:
        name = os.path.basename(prefix)
        f.write(f'model_checkpoint_path: "{name}"\nall_model_checkpoint_paths: "{name}"\n')
    return prefix


if __name__ == "__main__":
    print(write(sys.argv[1] if len(sys.argv) > 1 else FIXTURE_DIR))
