"""The native runner's routes of the models with no fast route (ROADMAP item
14c.5): AttentionPoolingModel (``attention_pooling``), LstmModel
(``rnn_lstm``) and GruModel (``rnn_gru``), each the flax graph's arithmetic
in f32, at small widths: D=16, two heads of 8, four queries; two layers of
12 cells (one layer in a case of its own); F=6 frames with pads, a record
longer than F and one of no frames.

For each model, the same seeded flax tree is exported with
``with_stablehlo=True`` by both packages, and:

- the artifact's arrays equal the flax leaves laid out as the kernels read
  them (composed here from the tree with NumPy) bit for bit; the manifest's
  lines that the JAX package also writes equal its lines, and the port's own
  lines are the ones its route needs;
- ``plain_run`` (the runner's plain version) is within 1e-6 of the port's
  model-forward serve (the gating BN is folded and the query projection
  made once, so its bits may differ);
- ``plain_run`` is within 1e-5 of JAX's ``make_predict_step`` on the CPU,
  on batches that hold a row of no frames and a row of F frames;
- each new kernel's plain version agrees with a float64 loop, and the carry
  index with flax's ``_select_last_carry``;
- on the CPU the new wrappers (and the f32 modes of ``gating`` and
  ``bias_act``) take their plain versions and launch nothing;
- the configs outside the routes are refused, naming ROADMAP item 14c; a
  manifest without a line its route needs is refused by the Python reader
  and by lpm_serve's C++ reader (over the host-only stand-in runner,
  tests/_torch_fake_runner.cc).

The runner itself runs on the card only (chip_smoke.py's native_routes
phase holds it against the torch routes there).
"""

import dataclasses
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from learnablepoolingmethods_torch import export_model as tem
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import native_runtime as nr
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.step import inference_forward
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.ops import native_tail as nt

from learnablepoolingmethods_tpu import config as jconfig
from learnablepoolingmethods_tpu import export_model as jem

# plain_run against the port's model forward (the same f32 arithmetic but
# for the folded gating BN and the shared query projection), and against
# JAX's make_predict_step (the f32 routes' tolerance)
MODEL_TOL, F32_TOL = 1e-6, 1e-5
BATCH, TOP_K, MAXF, CELLS = 4, 5, 6, 12
FCFG = FeatureConfig(("rgb", "audio"), (12, 4), True, MAXF)
SMALL = dict(vocab_size=24, attention_hidden_size=16, attention_heads=2, attention_cluster_size=4,
             lstm_cells=CELLS, gru_cells=CELLS, moe_num_mixtures=2)
# case → (model, config overrides)
CASES = {
    "AttentionPoolingModel": ("AttentionPoolingModel", {}),
    "AttentionPoolingModel_remove_diag": ("AttentionPoolingModel", dict(gating_remove_diag=True)),
    "LstmModel": ("LstmModel", {}),
    "LstmModel_one_layer": ("LstmModel", dict(lstm_layers=1)),
    "GruModel": ("GruModel", {}),
    "GruModel_three_layers": ("GruModel", dict(gru_layers=3)),
}
# 64 queries over 900 frames at a head width of 8: pool_attention's first
# design kept the 64 × 900 logits in shared memory and refused this export
LONG_FCFG = FeatureConfig(("rgb", "audio"), (12, 4), True, 900)
LONG = {"AttentionPoolingModel_900_frames": ("AttentionPoolingModel", dict(attention_cluster_size=64))}
ALL_CASES = {**CASES, **LONG}
FAKE_RUNNER = Path(__file__).resolve().parent / "_torch_fake_runner.cc"


def _mcfg(case):
    return ModelConfig(**{**SMALL, **ALL_CASES[case][1]})


def _fcfg(case):
    return LONG_FCFG if case in LONG else FCFG


def _tree(case):
    """A seeded tree with BN statistics off their init and the MoE scaled
    up, so that folding is exercised and scores spread."""
    tree = weights.init_variables_np(_mcfg(case), _fcfg(case), seed=3, model_name=ALL_CASES[case][0])

    def shifted(stats):
        return {k: shifted(v) if isinstance(v, dict) else v + np.float32(0.1) for k, v in stats.items()}

    tree["batch_stats"] = shifted(tree["batch_stats"])
    head = tree["params"]["MoeModel_0"]
    for name in ("gates_kernel", "experts_kernel"):
        head[name] = head[name] * np.float32(3)
    return tree


def _records(fcfg=FCFG):
    """Records of as many, fewer and more frames than max_frames, one frame,
    none, and audio shorter than rgb."""
    rng = np.random.default_rng(1)
    out = []
    f = fcfg.max_frames
    for i, (n_rgb, n_aud) in enumerate(((f, f), (3, 3), (f + 3, f + 3), (0, 0), (1, 1), (5, 2), (2, 2), (f, f))):
        rgb = rng.integers(0, 256, (n_rgb, fcfg.feature_sizes[0]), dtype=np.uint8)
        aud = rng.integers(0, 256, (n_aud, fcfg.feature_sizes[1]), dtype=np.uint8)
        out.append(fixtures.encode_frame_sequence_example(b"v%d" % i, [1], rgb, aud, feature_names=fcfg.feature_names))
    return out


def _batches(fcfg=FCFG):
    records = _records(fcfg)
    for start in range(0, len(records), BATCH):
        yield records[start:start + BATCH]


_EXPORTS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("native_rnn_routes")


def _exports(root, case):
    """The case's tree exported with with_stablehlo=True by both packages
    (once a module)."""
    if case not in _EXPORTS:
        model, fcfg = ALL_CASES[case][0], _fcfg(case)
        mcfg, tree = _mcfg(case), _tree(case)
        jm = jconfig.ModelConfig(**dataclasses.asdict(mcfg))
        jf = jconfig.FeatureConfig(**dataclasses.asdict(fcfg))
        jax_dir = jem.export_model(str(root / f"jax_{case}"), model, jm, jf, tree["params"], tree["batch_stats"],
                                   top_k=TOP_K, with_stablehlo=True, stablehlo_batch_size=BATCH)
        assert not os.path.exists(os.path.join(jax_dir, "stablehlo_error.txt"))
        port_dir = tem.export_model(str(root / f"port_{case}"), model, mcfg, fcfg, tree["params"],
                                    tree["batch_stats"], top_k=TOP_K, with_stablehlo=True,
                                    stablehlo_batch_size=BATCH)
        _EXPORTS[case] = {"tree": tree, "jax": jax_dir, "port": port_dir}
    return _EXPORTS[case]


def _lines(d):
    with open(os.path.join(d, nr.MANIFEST_FILE)) as f:
        return f.read().splitlines()


def _expected_arrays(case, tree) -> dict:
    """The route's arrays composed from the flax tree with NumPy: the gate
    kernels side by side in flax's order, pool_mha's projections flattened,
    the gating BN folded as scale / √(var + ε) and bias − mean · that."""
    model, mcfg = CASES[case][0], _mcfg(case)
    p, s = tree["params"], tree["batch_stats"]
    f32 = np.float32
    out = {}
    if model == "AttentionPoolingModel":
        mha = p["attn_pool"]["pool_mha"]
        d = mcfg.attention_hidden_size
        gate_w = np.asarray(p["gating"]["gating_weights"], f32)
        if mcfg.gating_remove_diag:
            gate_w = gate_w - np.diag(np.diag(gate_w))
        bn, st = p["gating"]["gating_bn"], s["gating"]["gating_bn"]
        g_scale = np.asarray(bn["scale"], f32) / np.sqrt(np.asarray(st["var"], f32) + f32(1e-3))
        out.update(w_proj=p["input_proj"]["kernel"], b_proj=p["input_proj"]["bias"], queries=p["attn_pool"]["queries"],
                   wq=np.reshape(mha["query"]["kernel"], (d, -1)), bq=np.reshape(mha["query"]["bias"], -1),
                   wkv=np.concatenate([np.reshape(mha[k]["kernel"], (d, -1)) for k in ("key", "value")], axis=1),
                   bkv=np.concatenate([np.reshape(mha[k]["bias"], -1) for k in ("key", "value")]),
                   wo=np.reshape(mha["out"]["kernel"], (-1, d)), bo=mha["out"]["bias"],
                   hidden_w=p["hidden1_weights"], hidden_b=p["hidden1_biases"], gate_w=gate_w, g_scale=g_scale,
                   g_bias=np.asarray(bn["bias"], f32) - np.asarray(st["mean"], f32) * g_scale)
    else:
        lstm = model == "LstmModel"
        prefix, gates = ("OptimizedLSTMCell_", "ifgo") if lstm else ("GRUCell_", "rzn")
        layers = mcfg.lstm_layers if lstm else mcfg.gru_layers
        for i in range(layers):
            cell = p[f"{prefix}{i}"]

            def cat(side, leaf):
                return np.concatenate([np.asarray(cell[side + g][leaf], f32) for g in gates], axis=-1)

            out[f"layers/{i}/w_i"] = cat("i", "kernel")
            if lstm:
                out[f"layers/{i}/w_h"], out[f"layers/{i}/b_h"] = cat("h", "kernel"), cat("h", "bias")
            else:
                out[f"layers/{i}/b_i"], out[f"layers/{i}/w_h"] = cat("i", "bias"), cat("h", "kernel")
                out[f"layers/{i}/b_hn"] = cell["hn"]["bias"]
    out.update({name: p["MoeModel_0"][name] for name in nr.MOE})
    return {name: np.ascontiguousarray(value, dtype=f32) for name, value in out.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_holds_the_flax_leaves_bit_for_bit(root, case):
    ex = _exports(root, case)
    manifest, arrays = nr.read_artifact(ex["port"])
    want = _expected_arrays(case, ex["tree"])
    names = [name for name, _, _ in manifest["weights"]]
    route = nr.MODEL_ROUTES[CASES[case][0]]
    assert manifest["route"] == route
    assert names == list(want) == list(nr.route_arrays(route, n_layers=manifest.get("rnn_layers", 2)))
    for name in names:
        got = nr.array_of(arrays, name)
        assert got.dtype == torch.float32 and got.shape == want[name].shape, name
        np.testing.assert_array_equal(got.numpy().view(np.int32), want[name].view(np.int32), err_msg=name)
    assert os.path.getsize(os.path.join(ex["port"], nr.WEIGHTS_FILE)) == sum(a.nbytes for a in want.values())


@pytest.mark.parametrize("case", list(CASES))
def test_manifest_shares_the_jax_lines(root, case):
    ex = _exports(root, case)
    port, jax_lines = _lines(ex["port"]), _lines(ex["jax"])
    own = nr.ROUTE_LINES[nr.MODEL_ROUTES[CASES[case][0]]]
    shared = [line for line in port if line.split()[0] not in own + ("n_weights", "weight")]
    assert shared == [line for line in jax_lines if line.split()[0] not in ("n_weights", "weight")]
    assert f"call_input u8 3 {BATCH} {MAXF} {FCFG.total_size}" in shared
    got = {line.split()[0]: line.split()[1:] for line in port if line.split()[0] in own}
    assert list(got) == list(own)
    mcfg = _mcfg(case)
    assert got["moe_num_mixtures"] == [str(mcfg.moe_num_mixtures)]
    if CASES[case][0] == "AttentionPoolingModel":
        assert got["attention_heads"] == [str(mcfg.attention_heads)]
        assert got["attention_cluster_size"] == [str(mcfg.attention_cluster_size)]
    else:
        layers = mcfg.lstm_layers if CASES[case][0] == "LstmModel" else mcfg.gru_layers
        assert got["rnn_layers"] == [str(layers)] and got["rnn_cells"] == [str(CELLS)]
    assert "sampling_key" not in got and "route" not in {line.split()[0] for line in jax_lines}


def _model_probs(case, tree, feats, nfs):
    """The port's model-forward route (the f32 forward the serve runs)."""
    model = create_model(CASES[case][0], _mcfg(case), FCFG.total_size)
    weights.load_flax_variables(model, tree)
    forward = inference_forward(model.eval(), _mcfg(case), True)
    with torch.no_grad():
        return forward(torch.from_numpy(feats), torch.from_numpy(nfs)).float()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_run_is_the_port_model_forward(root, case):
    ex = _exports(root, case)
    manifest, arrays = nr.read_artifact(ex["port"])
    *_, serve = tem.load_exported_model(ex["port"], prefer_fast=True, device="cpu")
    for batch in _batches():
        feats, nfs = tem.parse_serialized_records(FCFG, batch)
        probs = nr.plain_run(manifest, arrays, feats, nfs, return_probs=True)
        assert probs.shape == (BATCH, SMALL["vocab_size"]) and bool(torch.isfinite(probs).all())
        np.testing.assert_allclose(probs.numpy(), _model_probs(case, ex["tree"], feats, nfs).numpy(),
                                   atol=MODEL_TOL, rtol=0)
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        np.testing.assert_array_equal(torch.gather(probs, 1, indices).numpy(), values.numpy())
        want_indices, want_values = serve(batch)
        np.testing.assert_allclose(values.numpy(), want_values, atol=MODEL_TOL, rtol=0)


@pytest.mark.parametrize("case", list(CASES) + list(LONG))
def test_plain_run_against_the_jax_predict_step(root, case):
    """Against JAX's make_predict_step on the CPU (the graph its export
    serves): every probability within F32_TOL, on batches that hold a row
    of no frames and one of F."""
    import jax

    from learnablepoolingmethods_tpu.core import step as jstep
    from learnablepoolingmethods_tpu.models import create_model as jcreate

    ex = _exports(root, case)
    fcfg = _fcfg(case)
    jm = jconfig.ModelConfig(**dataclasses.asdict(_mcfg(case)))
    vocab = SMALL["vocab_size"]
    predict = jax.jit(jstep.make_predict_step(jcreate(ALL_CASES[case][0], jm), jm, True, top_k=vocab))
    manifest, arrays = nr.read_artifact(ex["port"])
    seen = set()
    for batch in _batches(fcfg):
        feats, nfs = tem.parse_serialized_records(fcfg, batch)
        seen |= set(nfs.tolist())
        got = nr.plain_run(manifest, arrays, feats, nfs, return_probs=True).numpy()
        values, indices = (np.asarray(a) for a in predict(ex["tree"]["params"], ex["tree"]["batch_stats"], feats, nfs))
        want = np.zeros_like(got)
        np.put_along_axis(want, indices, values, axis=1)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    assert {0, fcfg.max_frames} <= seen


# ---- the new kernels' plain versions against float64 loops

def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale)


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


NUM_FRAMES = torch.tensor([5, 0, 2, 9, 1], dtype=torch.int32)


def _last(nf: int, frames: int) -> int:
    return (min(nf, frames) - 1) % frames


def test_last_frame_is_flax_select_last_carry():
    """The carry index against flax's own selection: a row of no frames
    takes the carry after the last frame, a row past F the last too."""
    import jax.numpy as jnp
    from flax.linen.recurrent import _select_last_carry

    frames = 6
    nf = torch.tensor([0, 1, 3, 6, 9], dtype=torch.int32)
    seq = jnp.arange(frames * nf.shape[0]).reshape(frames, nf.shape[0])  # time-major, as nn.RNN scans
    want = np.asarray(_select_last_carry(seq, jnp.minimum(jnp.asarray(nf.numpy()), frames)))
    got = nt.last_frame(nf, frames)
    np.testing.assert_array_equal(np.asarray(seq)[got.numpy(), np.arange(nf.shape[0])], want)
    assert got.tolist() == [_last(n, frames) for n in nf.tolist()] == [5, 0, 2, 5, 5]


@pytest.mark.parametrize("t", [0, 2, 4])
def test_lstm_cell_plain_in_float64(t):
    b, h, frames = 5, 3, 5
    pre, hw, b_h = _rand(b, 4 * h, seed=1, scale=2), _rand(b, 4 * h, seed=2, scale=2), _rand(4 * h, seed=3)
    c, carry = _rand(b, h, seed=4), _rand(b, h, seed=5)
    h1, c1, carry1 = nt.lstm_cell_plain(pre, hw, b_h, c, carry, NUM_FRAMES, t, frames)
    want_h, want_c, want_carry = np.zeros((b, h)), np.zeros((b, h)), carry.double().numpy().copy()
    for r in range(b):
        for j in range(h):
            z = [float(hw[r, g * h + j]) + float(b_h[g * h + j]) + float(pre[r, g * h + j]) for g in range(4)]
            want_c[r, j] = _sig(z[1]) * float(c[r, j]) + _sig(z[0]) * np.tanh(z[2])
            want_h[r, j] = _sig(z[3]) * np.tanh(want_c[r, j])
            if _last(int(NUM_FRAMES[r]), frames) == t:
                want_carry[r, j] = want_h[r, j]
    np.testing.assert_allclose(c1.numpy(), want_c, atol=1e-6)
    np.testing.assert_allclose(h1.numpy(), want_h, atol=1e-6)
    np.testing.assert_allclose(carry1.numpy(), want_carry, atol=1e-6)
    assert torch.equal(nt.lstm_cell_plain(pre, hw, b_h, c)[0], h1)


@pytest.mark.parametrize("t", [0, 4])
def test_gru_cell_plain_in_float64(t):
    b, h, frames = 5, 3, 5
    pre, hw = _rand(b, 3 * h, seed=1, scale=2), _rand(b, 3 * h, seed=2, scale=2)
    b_i, b_hn, state, carry = _rand(3 * h, seed=3), _rand(h, seed=4), _rand(b, h, seed=5), _rand(b, h, seed=6)
    h1, carry1 = nt.gru_cell_plain(pre, hw, b_i, b_hn, state, carry, NUM_FRAMES, t, frames)
    want, want_carry = np.zeros((b, h)), carry.double().numpy().copy()
    for r in range(b):
        for j in range(h):
            x = [float(pre[r, g * h + j]) + float(b_i[g * h + j]) for g in range(3)]
            rr = _sig(x[0] + float(hw[r, j]))
            zz = _sig(x[1] + float(hw[r, h + j]))
            n = np.tanh(x[2] + rr * (float(hw[r, 2 * h + j]) + float(b_hn[j])))
            want[r, j] = (1 - zz) * n + zz * float(state[r, j])
            if _last(int(NUM_FRAMES[r]), frames) == t:
                want_carry[r, j] = want[r, j]
    np.testing.assert_allclose(h1.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(carry1.numpy(), want_carry, atol=1e-6)


def test_pool_attention_plain_in_float64():
    """Q queries over every frame: q / √hd before the dot, masked frames
    out, a row of no frames the plain mean of its values over all F."""
    b, frames, n_q, heads, hd = 5, 6, 3, 2, 4
    d = heads * hd
    q, kv, bkv = _rand(n_q, d, seed=1), _rand(b, frames, 2 * d, seed=2), _rand(2 * d, seed=3, scale=0.1)
    got = nt.pool_attention_plain(q, kv, bkv, NUM_FRAMES, heads)
    k = (kv[..., :d] + bkv[:d]).double().numpy()
    v = (kv[..., d:] + bkv[d:]).double().numpy()
    qd = q.double().numpy()
    want = np.zeros((b, n_q, d))
    for r in range(b):
        valid = min(int(NUM_FRAMES[r]), frames)
        for i in range(n_q):
            for hh in range(heads):
                sl = slice(hh * hd, (hh + 1) * hd)
                keep = list(range(valid)) if valid else list(range(frames))
                logits = np.array([qd[i, sl] @ k[r, f, sl] / np.sqrt(hd) for f in keep])
                w = np.exp(logits - logits.max()) if valid else np.ones(frames)  # all masked: uniform
                w /= w.sum()
                want[r, i, sl] = sum(w[n] * v[r, f, sl] for n, f in enumerate(keep))
    assert got.shape == (b, n_q, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(v[1].mean(0), (n_q, d)), atol=1e-5)


def test_pool_attention_fits_the_block():
    """The kernel's shared memory does not grow with Q or F (an online
    softmax over tiles of 32 frames): 64 queries, two stages of a key and a
    value tile, the tile's weights and a float a query, two blocks an SM."""
    assert nt.pool_attention_fits(64, 300, 128)
    assert not nt.pool_attention_fits(64, 300, 256)
    assert nt.pool_attention_fits(64, 900, 128) and nt.pool_attention_fits(5, 100_000, 40)
    assert nt.POOL_SMEM == 4 * (64 * 136 + 4 * 32 * 136 + 32 * 72 + 64)
    assert 2 * (nt.POOL_SMEM + 1024) <= 233_472


def test_the_new_wrappers_take_their_plain_versions_on_the_cpu():
    b, h, frames = 5, 4, 5
    pre = _rand(b, frames, 4 * h, seed=1)
    hw, b_h, c = _rand(b, 4 * h, seed=2), _rand(4 * h, seed=3), _rand(b, h, seed=4)
    kv, q = _rand(b, frames, 2 * 8, seed=5), _rand(3, 8, seed=6)
    y, bias = _rand(4, 8, seed=7), _rand(8, seed=8)
    before = {w: w.launches for w in nt.WRAPPERS}
    for got, want in (
            (nt.lstm_cell(pre[:, 2], hw, b_h, c, c, NUM_FRAMES, 2, frames),
             nt.lstm_cell_plain(pre[:, 2], hw, b_h, c, c, NUM_FRAMES, 2, frames)),
            (nt.gru_cell(pre[:, 1, :3 * h], hw[:, :3 * h], b_h[:3 * h], b_h[:h], c, c, NUM_FRAMES, 1, frames),
             nt.gru_cell_plain(pre[:, 1, :3 * h], hw[:, :3 * h], b_h[:3 * h], b_h[:h], c, c, NUM_FRAMES, 1, frames)),
            ((nt.pool_attention(q, kv, kv[0, 0], NUM_FRAMES, 2),),
             (nt.pool_attention_plain(q, kv, kv[0, 0], NUM_FRAMES, 2),)),
            ((nt.gating(y, y, bias, bias, torch.float32),), (nt.gating_plain(y, y, bias, bias, torch.float32),)),
            ((nt.bias_act(y, bias, dtype=torch.float32),), (nt.bias_act_plain(y, bias, dtype=torch.float32),))):
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    assert nt.gating(y, y, bias, bias, torch.float32).dtype == torch.float32
    assert {w: w.launches for w in nt.WRAPPERS} == before


# ---- refusals

VCFG = FeatureConfig(("mean_rgb", "mean_audio"), (12, 4), False)
OUTSIDE_THE_ROUTES = {
    "pooling_bf16": ("AttentionPoolingModel", dict(compute_dtype="bfloat16"), FCFG),
    "pooling_no_gating": ("AttentionPoolingModel", dict(gating=False), FCFG),
    "pooling_no_batch_norm": ("AttentionPoolingModel", dict(netvlad_add_batch_norm=False), FCFG),
    "pooling_head_width_256": ("AttentionPoolingModel", dict(attention_hidden_size=512, attention_heads=2), FCFG),
    "pooling_logistic_head": ("AttentionPoolingModel", dict(video_level_classifier_model="LogisticModel"), FCFG),
    "lstm_bf16": ("LstmModel", dict(compute_dtype="bfloat16"), FCFG),
    "lstm_video_level": ("LstmModel", {}, VCFG),
    "lstm_presampled": ("LstmModel", dict(presampled=True), FCFG),
    "gru_bf16": ("GruModel", dict(compute_dtype="bfloat16"), FCFG),
    "gru_logistic_head": ("GruModel", dict(video_level_classifier_model="LogisticModel"), FCFG),
}


@pytest.mark.parametrize("case", list(OUTSIDE_THE_ROUTES))
def test_what_remains_is_refused_naming_item_14c(tmp_path, case):
    model, overrides, fcfg = OUTSIDE_THE_ROUTES[case]
    mcfg = ModelConfig(**{**SMALL, **overrides})
    tree = weights.init_variables_np(mcfg, fcfg, seed=0, model_name=model)
    export_dir = str(tmp_path / "e")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
        tem.export_model(export_dir, model, mcfg, fcfg, tree["params"], tree["batch_stats"], with_stablehlo=True)
    assert not os.path.exists(export_dir)


@pytest.fixture(scope="module")
def lpm_serve(tmp_path_factory):
    binary = tmp_path_factory.mktemp("lpm_serve_fake") / "lpm_serve"
    out = subprocess.run(nr.serving_binary_command(FAKE_RUNNER, binary), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return str(binary)


@pytest.mark.parametrize("case,line", [("AttentionPoolingModel", "attention_heads"),
                                       ("AttentionPoolingModel", "attention_cluster_size"),
                                       ("LstmModel", "rnn_layers"), ("GruModel", "rnn_cells"),
                                       ("GruModel", "moe_num_mixtures")])
def test_a_manifest_without_its_lines_is_refused(root, tmp_path, lpm_serve, case, line):
    src = _exports(root, case)["port"]
    check = subprocess.run([lpm_serve, f"--export_dir={src}", "--check"], capture_output=True, text=True, timeout=60)
    assert check.returncode == 0, check.stderr
    dst = str(tmp_path / "edited")
    shutil.copytree(src, dst)
    with open(os.path.join(dst, nr.MANIFEST_FILE), "w") as f:
        f.write("\n".join(x for x in _lines(src) if x.split()[0] != line) + "\n")
    message = f"route {nr.MODEL_ROUTES[CASES[case][0]]} needs the line '{line}'"
    with pytest.raises(ValueError, match=message):
        nr.read_manifest(dst)
    check = subprocess.run([lpm_serve, f"--export_dir={dst}", "--check"], capture_output=True, text=True, timeout=60)
    assert check.returncode != 0 and message in check.stderr, check.stderr
