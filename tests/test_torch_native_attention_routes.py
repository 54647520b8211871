"""The native runner's routes of the models that read every frame (ROADMAP
items 14c.3 and part of 14c.5): TransformerEncoderModel
(``fast_transformer``), AttentionNetVLADModel (``fast_attn_netvlad``) and
FrameLevelLogisticModel (``frame_logistic``), at small widths: D=16, two
heads of 8, two encoder layers (one in a case of its own), FFN 16, K=4,
F=6 frames with pads, a record longer than F and one of no frames.

For each model, the same seeded flax tree is exported with
``with_stablehlo=True`` by both packages, and:

- the artifact's arrays equal the route's prepare (``device="cpu"``) bit
  for bit; the manifest's lines that the JAX package also writes equal its
  lines, and the port's own lines are the ones its route needs;
- ``plain_run`` (the runner's plain version) equals the port's serve bit for
  bit: the fast serve for the attention two, the model-forward serve for
  FrameLevelLogisticModel (it has no fast route);
- ``plain_run`` of the attention two is within ``JAX_FAST_TOL`` of JAX's
  fast route in bf16 with its Pallas kernel in interpret mode, and within
  3e-2 of JAX's flax serve; ``frame_logistic`` is within 1e-5 of JAX's
  ``make_predict_step``;
- each new kernel's plain version agrees with an independent composition
  (float64, explicit loops; LayerNorm also against JAX's ``_layernorm``);
- the configs outside the routes still refuse, naming ROADMAP item 14c; a
  manifest of an attention route without ``transformer_layers`` is refused
  by the Python reader and by lpm_serve's C++ reader (over the host-only
  stand-in runner, tests/_torch_fake_runner.cc).

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
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.ops import native_tail as nt
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path

from learnablepoolingmethods_tpu import config as jconfig
from learnablepoolingmethods_tpu import export_model as jem

# plain_run against JAX's flax serve (the graph its --native_serve exports),
# as the other bf16 routes are held (tests/test_torch_native_routes.py), and
# against JAX's bf16 fast route: the same rounding points, the Pallas kernel
# in interpret mode, so only f32 summation orders differ (6.0e-8 at most on
# these batches; a bf16 rounding moved by them would show as ~1e-3)
BF16_TOL, JAX_FAST_TOL, F32_TOL = 3e-2, 1e-5, 1e-5
BATCH, TOP_K, MAXF = 4, 5, 6
FCFG = FeatureConfig(("rgb", "audio"), (12, 4), True, MAXF)
SMALL = dict(vocab_size=24, attention_hidden_size=16, attention_heads=2, transformer_layers=2,
             transformer_ff_size=16, moe_num_mixtures=2, netvlad_cluster_size=4, netvlad_hidden_size=16)
# case → (model, config overrides)
CASES = {
    "TransformerEncoderModel": ("TransformerEncoderModel", {}),
    "TransformerEncoderModel_one_layer": ("TransformerEncoderModel", dict(transformer_layers=1)),
    "AttentionNetVLADModel": ("AttentionNetVLADModel", {}),
    "FrameLevelLogisticModel": ("FrameLevelLogisticModel", {}),
}
ATTENTION = tuple(c for c in CASES if CASES[c][0] != "FrameLevelLogisticModel")
# the two under --gating_remove_diag: the export zeroes the gating diagonal
# that the fast prepare keeps (flax's ContextGating drops it)
REMOVE_DIAG = {f"{c}_remove_diag": (CASES[c][0], dict(gating_remove_diag=True))
               for c in ("TransformerEncoderModel", "AttentionNetVLADModel")}
ALL_CASES = {**CASES, **REMOVE_DIAG}
FAKE_RUNNER = Path(__file__).resolve().parent / "_torch_fake_runner.cc"


def _mcfg(case):
    return ModelConfig(**{**SMALL, **ALL_CASES[case][1]})


def _tree(case):
    """A seeded tree with BN statistics off their init and the heads scaled
    up, so that folding is exercised and scores spread."""
    model = ALL_CASES[case][0]
    tree = weights.init_variables_np(_mcfg(case), FCFG, seed=3, model_name=model)

    def shifted(stats):
        return {k: shifted(v) if isinstance(v, dict) else v + np.float32(0.1) for k, v in stats.items()}

    tree["batch_stats"] = shifted(tree["batch_stats"])
    params = tree["params"]
    head = params["fc"] if model == "FrameLevelLogisticModel" else params["MoeModel_0"]
    for name in ("kernel", "gates_kernel", "experts_kernel"):
        if name in head:
            head[name] = head[name] * np.float32(3)
    return tree


def _records():
    """Records of as many, fewer and more frames than max_frames, one frame,
    none, and audio shorter than rgb."""
    rng = np.random.default_rng(1)
    out = []
    for i, (n_rgb, n_aud) in enumerate(((6, 6), (3, 3), (9, 9), (0, 0), (1, 1), (5, 2), (2, 2))):
        rgb = rng.integers(0, 256, (n_rgb, FCFG.feature_sizes[0]), dtype=np.uint8)
        aud = rng.integers(0, 256, (n_aud, FCFG.feature_sizes[1]), dtype=np.uint8)
        out.append(fixtures.encode_frame_sequence_example(b"v%d" % i, [1], rgb, aud, feature_names=FCFG.feature_names))
    return out


def _batches():
    records = _records()
    for start in range(0, len(records), BATCH):
        chunk = records[start:start + BATCH]
        yield chunk + [chunk[-1]] * (BATCH - len(chunk))


_EXPORTS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("native_attention_routes")


def _exports(root, case):
    """The case's tree exported with with_stablehlo=True by both packages
    (once a module)."""
    if case not in _EXPORTS:
        model = ALL_CASES[case][0]
        mcfg, tree = _mcfg(case), _tree(case)
        jm = jconfig.ModelConfig(**dataclasses.asdict(mcfg))
        jf = jconfig.FeatureConfig(**dataclasses.asdict(FCFG))
        jax_dir = jem.export_model(str(root / f"jax_{case}"), model, jm, jf, tree["params"], tree["batch_stats"],
                                   top_k=TOP_K, with_stablehlo=True, stablehlo_batch_size=BATCH)
        assert not os.path.exists(os.path.join(jax_dir, "stablehlo_error.txt"))
        port_dir = tem.export_model(str(root / f"port_{case}"), model, mcfg, FCFG, tree["params"],
                                    tree["batch_stats"], top_k=TOP_K, with_stablehlo=True,
                                    stablehlo_batch_size=BATCH)
        _EXPORTS[case] = {"tree": tree, "jax": jax_dir, "port": port_dir}
    return _EXPORTS[case]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _prepared(case, tree):
    """The route's prepare on the CPU, as the export calls it."""
    model = CASES[case][0]
    variables = weights.convert_flax_variables(tree, _mcfg(case), model)
    if model == "FrameLevelLogisticModel":
        p = variables["params"]
        return {"fc": {"kernel": p["fc"]["kernel"].float(), "bias": p["fc"]["bias"].float()}}
    return get_fast_path(model).prepare(variables, _mcfg(case), device="cpu")


def _lines(d):
    with open(os.path.join(d, nr.MANIFEST_FILE)) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_holds_the_route_prepare_bit_for_bit(root, case):
    ex = _exports(root, case)
    manifest, arrays = nr.read_artifact(ex["port"])
    want = _prepared(case, ex["tree"])
    names = [name for name, _, _ in manifest["weights"]]
    route = nr.MODEL_ROUTES[CASES[case][0]]
    assert manifest["route"] == route
    assert names == list(nr.route_arrays(route, n_layers=_mcfg(case).transformer_layers))
    nbytes = 0
    for name in names:
        got, ref = nr.array_of(arrays, name), nr.array_of(want, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert torch.equal(_bits(got), _bits(ref.contiguous())), name
        nbytes += got.numel() * got.element_size()
    assert os.path.getsize(os.path.join(ex["port"], nr.WEIGHTS_FILE)) == nbytes


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
    if case in ATTENTION:
        assert got["transformer_layers"] == [str(mcfg.transformer_layers)]
        assert got["attention_heads"] == [str(mcfg.attention_heads)]
        assert got["moe_num_mixtures"] == [str(mcfg.moe_num_mixtures)]
    else:
        assert own == ("route",)
    assert "sampling_key" not in got and "route" not in {line.split()[0] for line in jax_lines}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_run_is_the_port_serve_bit_for_bit(root, case):
    ex = _exports(root, case)
    manifest, arrays = nr.read_artifact(ex["port"])
    *_, serve = tem.load_exported_model(ex["port"], prefer_fast=True, device="cpu")
    seen_empty = False
    for batch in _batches():
        feats, nfs = tem.parse_serialized_records(FCFG, batch)
        seen_empty |= bool((nfs == 0).any())
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        want_indices, want_values = serve(batch)
        np.testing.assert_array_equal(indices.numpy(), want_indices)
        np.testing.assert_array_equal(values.float().numpy(), want_values)
        probs = nr.plain_run(manifest, arrays, feats, nfs, return_probs=True)
        assert probs.shape == (BATCH, SMALL["vocab_size"]) and bool(torch.isfinite(probs).all())
        np.testing.assert_array_equal(torch.gather(probs, 1, indices).numpy(), values.numpy())
    assert seen_empty


def _close(got, want, tol):
    """Scores within ``tol`` on the classes both return (near-ties may swap
    one class at the edge of the top-k)."""
    (gi, gv), (wi, wv) = got, want
    assert gi.shape == wi.shape and np.isfinite(gv).all()
    np.testing.assert_allclose(gv, wv, atol=tol)
    for grow, gvals, wrow, wvals in zip(gi, gv, wi, wv):
        shared = set(grow.tolist()) & set(wrow.tolist())
        assert len(shared) >= len(grow) - 1
        g, w = dict(zip(grow.tolist(), gvals)), dict(zip(wrow.tolist(), wvals))
        assert all(abs(g[c] - w[c]) <= tol for c in shared)


@pytest.mark.parametrize("case", ATTENTION)
def test_plain_run_against_the_jax_fast_route(root, case):
    """Against JAX's bf16 fast route (its masked-attention and NetVLAD
    Pallas kernels in interpret mode) on the JAX prepare of the same tree:
    the probabilities within JAX_FAST_TOL."""
    import jax.numpy as jnp

    from learnablepoolingmethods_tpu.ops import fast_transformer as jft

    ex = _exports(root, case)
    model = CASES[case][0]
    jm = jconfig.ModelConfig(**dataclasses.asdict(_mcfg(case)))
    prepare, build = {"TransformerEncoderModel": (jft.prepare_fast_transformer_params,
                                                  jft.build_fast_transformer_inference),
                      "AttentionNetVLADModel": (jft.prepare_fast_attn_netvlad_params,
                                                jft.build_fast_attn_netvlad_inference)}[model]
    fp = prepare(ex["tree"], jm, compute_dtype=jnp.bfloat16)
    fn = build(jm, top_k=TOP_K, use_pallas=True, pallas_interpret=True, compute_dtype=jnp.bfloat16,
               return_probs=True)
    manifest, arrays = nr.read_artifact(ex["port"])
    for batch in _batches():
        feats, nfs = tem.parse_serialized_records(FCFG, batch)
        got = nr.plain_run(manifest, arrays, feats, nfs, return_probs=True)
        want = np.asarray(fn(fp, jnp.asarray(feats), jnp.asarray(nfs)), np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=JAX_FAST_TOL)


@pytest.mark.parametrize("case", ATTENTION + tuple(REMOVE_DIAG))
def test_plain_run_against_the_jax_flax_serve(root, case):
    """Against JAX's flax serve, the graph that its --native_serve exports,
    batch by batch as a server pads them."""
    ex = _exports(root, case)
    manifest, arrays = nr.read_artifact(ex["port"])
    *_, jax_serve = jem.load_exported_model(ex["jax"], prefer_fast=False)
    for batch in _batches():
        feats, nfs = tem.parse_serialized_records(FCFG, batch)
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        wi, wv = jax_serve(batch)
        _close((indices.numpy(), values.float().numpy()), (np.asarray(wi), np.asarray(wv)), BF16_TOL)


def test_frame_logistic_plain_run_against_the_jax_predict_step(root):
    import jax

    from learnablepoolingmethods_tpu.core import step as jstep
    from learnablepoolingmethods_tpu.models import create_model as jcreate

    case = "FrameLevelLogisticModel"
    ex = _exports(root, case)
    jm = jconfig.ModelConfig(**dataclasses.asdict(_mcfg(case)))
    predict = jax.jit(jstep.make_predict_step(jcreate(case, jm), jm, True, top_k=TOP_K))
    manifest, arrays = nr.read_artifact(ex["port"])
    for batch in _batches():
        feats, nfs = tem.parse_serialized_records(FCFG, batch)
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        wv, wi = predict(ex["tree"]["params"], ex["tree"]["batch_stats"], feats, nfs)
        np.testing.assert_array_equal(indices.numpy(), np.asarray(wi))
        np.testing.assert_allclose(values.numpy(), np.asarray(wv), atol=F32_TOL)


# ---- the new kernels' plain versions against independent compositions

def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_frame_stage_all_plain_in_float64(dtype):
    """Every frame: the dequantize in ``dtype`` (rounded after the multiply
    and after the add), ℓ2 in float64, one rounding; the mask f < nf."""
    rng = np.random.default_rng(5)
    b, f, dt = 4, 5, 16
    x = rng.integers(0, 256, (b, f, dt), dtype=np.uint8)
    x[1, 2] = 0
    nf = np.array([5, 0, 2, 9], np.int32)
    got, mask = nt.frame_stage_all_plain(torch.from_numpy(x), torch.from_numpy(nf), dtype)
    scale, bias = torch.tensor(4 / 255, dtype=dtype), torch.tensor(4 / 512 - 2, dtype=dtype)
    deq = (torch.from_numpy(x).to(dtype) * scale + bias).double()
    want = deq / torch.sqrt(torch.clamp((deq ** 2).sum(-1, keepdim=True), min=1e-12))
    step = 2 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert got.dtype == dtype and (got.double() - want).abs().max().item() <= step
    np.testing.assert_array_equal(mask.numpy(), (np.arange(f)[None, :] < nf[:, None]).astype(np.float32))


@pytest.mark.parametrize("relu", [False, True])
def test_bias_act_plain_rounds_once(relu):
    y, bias = _rand(6, 5, seed=3, scale=4.0), _rand(5, seed=4)
    got = nt.bias_act_plain(y, bias, relu)
    want = np.zeros((6, 5))
    for r in range(6):
        for c in range(5):
            z = float(y[r, c]) + float(bias[c])
            want[r, c] = max(z, 0.0) if relu else z
    assert got.dtype == torch.bfloat16
    # the f32 sum of two f32 values, then one bf16 rounding: within half a
    # bf16 step of the float64 value (and the f32 sum's own rounding)
    assert ((got.double() - torch.from_numpy(want)).abs() <= torch.from_numpy(np.abs(want)) * 2 ** -8 + 1e-6).all()
    assert torch.equal(got, (torch.relu(y + bias) if relu else y + bias).to(torch.bfloat16))


def test_residual_layernorm_plain_against_float64_and_jax():
    import jax.numpy as jnp

    from learnablepoolingmethods_tpu.ops.fast_transformer import _layernorm

    r, d = 6, 16
    x, y = _rand(r, d, seed=1).to(torch.bfloat16), _rand(r, d, seed=2).to(torch.bfloat16)
    scale, bias = _rand(d, seed=3, scale=0.2) + 1, _rand(d, seed=4, scale=0.1)
    mask = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.float32)
    got = nt.residual_layernorm_plain(x, y, scale, bias)
    masked = nt.residual_layernorm_plain(x, y, scale, bias, mask)
    s = x.double() + y.double()
    mean = s.mean(-1, keepdim=True)
    var = (s * s).mean(-1, keepdim=True) - mean * mean
    want = (s - mean) / torch.sqrt(var + 1e-6) * scale.double() + bias.double()
    assert got.dtype == torch.bfloat16
    assert (got.double() - want).abs().max().item() <= 2 ** -7 * want.abs().max().item()
    jax_ln = np.asarray(_layernorm(jnp.asarray((x.float() + y.float()).numpy()), jnp.asarray(scale.numpy()),
                                   jnp.asarray(bias.numpy())), np.float32)
    np.testing.assert_allclose(nt.layer_norm(x.float() + y.float(), scale, bias).numpy(), jax_ln, atol=1e-6)
    assert torch.equal(masked[mask == 1], got[mask == 1]) and not masked[mask == 0].any()
    # zeros keep the sign h · 0 gives them, as the torch route's h * mask
    assert torch.equal(torch.signbit(masked[mask == 0]), torch.signbit(got[mask == 0]))


@pytest.mark.parametrize("count_valid", [True, False])
def test_masked_mean_plain_in_loops(count_valid):
    b, f, c = 4, 5, 3
    x = _rand(b, f, c, seed=7).to(torch.bfloat16)
    nf = torch.tensor([5, 0, 2, 7], dtype=torch.int32)  # the last past F: Σ over F, divided by 7 unless counted
    got = nt.masked_mean_plain(x, nf, count_valid=count_valid)
    got32 = nt.masked_mean_plain(x, nf, torch.float32, count_valid)
    want = np.zeros((b, c))
    for i in range(b):
        n = max(0, min(int(nf[i]), f))
        denom = max(n if count_valid else int(nf[i]), 1)
        for j in range(c):
            want[i, j] = sum(float(x[i, t, j]) for t in range(n)) / denom
    np.testing.assert_allclose(got32.numpy(), want, atol=1e-6)
    assert got.dtype == torch.bfloat16 and torch.equal(got, got32.to(torch.bfloat16))


def test_the_new_wrappers_take_their_plain_versions_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, 8), dtype=np.uint8))
    nf = torch.tensor([3, 1], dtype=torch.int32)
    y, bias = _rand(4, 8, seed=1), _rand(8, seed=2)
    h, g = _rand(4, 8, seed=3).to(torch.bfloat16), _rand(4, 8, seed=4).to(torch.bfloat16)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    before = {w: w.launches for w in nt.WRAPPERS}
    for got, want in (
            (nt.frame_stage_all(x, nf), nt.frame_stage_all_plain(x, nf)),
            (nt.frame_stage_all(x, nf, torch.float32), nt.frame_stage_all_plain(x, nf, torch.float32)),
            ((nt.bias_act(y, bias, True),), (nt.bias_act_plain(y, bias, True),)),
            ((nt.residual_layernorm(h, g, bias, bias, mask),), (nt.residual_layernorm_plain(h, g, bias, bias, mask),)),
            ((nt.masked_mean(h.reshape(2, 2, 8), nf, torch.float32, False),),
             (nt.masked_mean_plain(h.reshape(2, 2, 8), nf, torch.float32, False),))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert {w: w.launches for w in nt.WRAPPERS} == before


# ---- refusals

OUTSIDE_THE_ROUTES = {
    "transformer_no_gating": ("TransformerEncoderModel", dict(gating=False)),
    "transformer_no_batch_norm": ("TransformerEncoderModel", dict(netvlad_add_batch_norm=False)),
    "attn_netvlad_relu": ("AttentionNetVLADModel", dict(netvlad_relu=True)),
    "attn_netvlad_no_batch_norm": ("AttentionNetVLADModel", dict(netvlad_add_batch_norm=False)),
    "head_width_4": ("TransformerEncoderModel", dict(attention_heads=4)),
    "frame_logistic_bf16": ("FrameLevelLogisticModel", dict(compute_dtype="bfloat16")),
    # the models of item 14c.5 have routes (tests/test_torch_native_rnn_routes.py):
    # these configs of theirs stay outside
    "attention_pooling": ("AttentionPoolingModel", dict(attention_cluster_size=2, gating=False)),
    "lstm": ("LstmModel", dict(lstm_cells=8, compute_dtype="bfloat16")),
    "gru": ("GruModel", dict(gru_cells=8, compute_dtype="bfloat16")),
}


@pytest.mark.parametrize("case", list(OUTSIDE_THE_ROUTES))
def test_what_remains_is_refused_naming_item_14c(tmp_path, case):
    model, overrides = OUTSIDE_THE_ROUTES[case]
    mcfg = ModelConfig(**{**SMALL, **overrides})
    tree = weights.init_variables_np(mcfg, FCFG, seed=0, model_name=model)
    export_dir = str(tmp_path / "e")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
        tem.export_model(export_dir, model, mcfg, FCFG, tree["params"], tree["batch_stats"], with_stablehlo=True)
    assert not os.path.exists(export_dir)


@pytest.fixture(scope="module")
def lpm_serve(tmp_path_factory):
    binary = tmp_path_factory.mktemp("lpm_serve_fake") / "lpm_serve"
    out = subprocess.run(nr.serving_binary_command(FAKE_RUNNER, binary), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return str(binary)


@pytest.mark.parametrize("case,line", [("TransformerEncoderModel", "transformer_layers"),
                                       ("AttentionNetVLADModel", "attention_heads")])
def test_an_attention_manifest_without_its_lines_is_refused(root, tmp_path, lpm_serve, case, line):
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
