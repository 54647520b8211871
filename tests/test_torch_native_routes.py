"""The native runner's routes beyond Willow's (ROADMAP items 14c.1 and
14c.2; the attention routes of 14c.3 are tests/test_torch_native_attention_routes.py's):
LogisticModel and MoeModel (video-level, f32), DbofModel (iid
frames, one window a video, max and average pooling), NetRVLADModelLF,
SoftDbofModelLF, NetFVModelLF and NeXtVLADModel, at small widths.

For each model, the same seeded flax tree is exported with
``with_stablehlo=True`` by both packages, and:

- the artifact's arrays equal the route's prepare (``device="cpu"``) bit
  for bit; the manifest's lines that the JAX package also writes equal its
  lines, and the port's own lines are the ones its route needs;
- ``plain_run`` (the runner's plain version) equals the port's serve bit for
  bit: the fast serve for DBoF and the LOUPE four, the model-forward serve
  for the video-level two (the DBoF window has no fast route);
- ``plain_run`` is within 3e-2 of JAX's flax serve for every bf16 route
  (the DBoF window at the config of JAX's tests/unit/test_native_runtime.py
  :101), and within 1e-5 of JAX's ``make_predict_step`` for the video-level
  two (JAX's own native test holds 1e-6 against its StableHLO runner);
- each new tail kernel's plain version agrees with an independent
  composition (float64, explicit loops, JAX's frame draws);
- the refusals that remain name ROADMAP item 14c; a manifest without a line
  its route needs, or with an unknown route, is refused with its name by the
  Python reader and by lpm_serve's C++ reader;
- lpm_serve, built against the host-only stand-in runner
  (tests/_torch_fake_runner.cc), parses video-level Example records into
  the f32 rows that the Python parser gives and answers each.

The runner itself runs on the card only (chip_smoke.py's native_routes
phase holds it against the torch routes there).
"""

import dataclasses
import json
import os
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
from learnablepoolingmethods_torch.serving import frame_records
from learnablepoolingmethods_torch.utils import prng

from learnablepoolingmethods_tpu import config as jconfig
from learnablepoolingmethods_tpu import export_model as jem

BF16_TOL, F32_TOL = 3e-2, 1e-5
BATCH, TOP_K, MAXF = 4, 5, 6
# JAX's tests/unit/test_native_runtime.py:101 features (DBoF); the LOUPE
# models pool two modalities past 1024 columns (frame_level.py#lf_layout);
# video-level features beside
FCFG = FeatureConfig(("rgb", "audio"), (12, 4), True, MAXF)
LCFG = FeatureConfig(("rgb", "audio"), (1024, 8), True, MAXF)
VCFG = FeatureConfig(("mean_rgb", "mean_audio"), (16, 4), False)
SMALL = dict(vocab_size=24, iterations=MAXF, moe_num_mixtures=2, dbof_cluster_size=16, dbof_hidden_size=8,
             rvlad_cluster_size=4, dbow_cluster_size=8, fv_cluster_size=4, fv_hidden_size=8,
             nextvlad_cluster_size=4, nextvlad_hidden_size=8, netvlad_hidden_size=8)
# case → (model, config overrides, features)
CASES = {
    "LogisticModel": ("LogisticModel", {}, VCFG),
    "MoeModel": ("MoeModel", {}, VCFG),
    "DbofModel": ("DbofModel", {}, FCFG),
    "DbofModel_average": ("DbofModel", dict(dbof_pooling_method="average"), FCFG),
    "DbofModel_window": ("DbofModel", dict(sample_random_frames=False), FCFG),
    "NetRVLADModelLF": ("NetRVLADModelLF", {}, LCFG),
    "SoftDbofModelLF": ("SoftDbofModelLF", {}, LCFG),
    "NetFVModelLF": ("NetFVModelLF", {}, LCFG),
    "NeXtVLADModel": ("NeXtVLADModel", {}, LCFG),
}
# the gated LOUPE routes under --gating_remove_diag: the export zeroes the
# gating diagonal that the fast prepare keeps (flax's ContextGating drops it)
REMOVE_DIAG = {
    "NetRVLADModelLF_remove_diag": ("NetRVLADModelLF", dict(gating_remove_diag=True), LCFG),
    "SoftDbofModelLF_remove_diag": ("SoftDbofModelLF", dict(gating_remove_diag=True), LCFG),
}
ALL_CASES = {**CASES, **REMOVE_DIAG}
VIDEO = ("LogisticModel", "MoeModel")
FAST = tuple(c for c in CASES if c not in VIDEO and c != "DbofModel_window")
FAKE_RUNNER = Path(__file__).resolve().parent / "_torch_fake_runner.cc"


def _mcfg(case):
    return ModelConfig(**{**SMALL, **ALL_CASES[case][1]})


def _tree(case):
    """A seeded tree with BN statistics off their init and the heads scaled
    up, so that folding is exercised and scores spread (frames from another
    key would then move them past 3e-2)."""
    model, _, fcfg = ALL_CASES[case]
    tree = weights.init_variables_np(_mcfg(case), fcfg, seed=3, model_name=model)

    def shifted(stats):
        return {k: shifted(v) if isinstance(v, dict) else v + np.float32(0.1) for k, v in stats.items()}

    tree["batch_stats"] = shifted(tree["batch_stats"])
    params = tree["params"]
    head = params["fc"] if model == "LogisticModel" else params.get("MoeModel_0", params)
    for name in ("kernel", "gates_kernel", "experts_kernel"):
        if name in head:
            head[name] = head[name] * np.float32(3)
    return tree


def _records(fcfg):
    """Frame-level records of more and fewer frames than max_frames, one
    frame, audio shorter than rgb; or video-level records."""
    rng = np.random.default_rng(1)
    if not fcfg.frame_features:
        return [fixtures.encode_video_example(b"v%d" % i, [1], rng.normal(size=fcfg.feature_sizes[0]).astype(np.float32),
                                              rng.normal(size=fcfg.feature_sizes[1]).astype(np.float32),
                                              feature_names=fcfg.feature_names) for i in range(6)]
    out = []
    for i, (n_rgb, n_aud) in enumerate(((6, 6), (3, 3), (9, 9), (1, 1), (5, 2), (2, 2))):
        rgb = rng.integers(0, 256, (n_rgb, fcfg.feature_sizes[0]), dtype=np.uint8)
        aud = rng.integers(0, 256, (n_aud, fcfg.feature_sizes[1]), dtype=np.uint8)
        out.append(fixtures.encode_frame_sequence_example(b"v%d" % i, [1], rgb, aud, feature_names=fcfg.feature_names))
    return out


def _batches(records):
    for start in range(0, len(records), BATCH):
        chunk = records[start:start + BATCH]
        yield chunk + [chunk[-1]] * (BATCH - len(chunk))


_EXPORTS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("native_routes")


def _exports(root, case):
    """The case's tree exported with with_stablehlo=True by both packages
    (once a module)."""
    if case not in _EXPORTS:
        model, _, fcfg = ALL_CASES[case]
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


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _prepared(case, tree):
    """The route's prepare on the CPU, as the export calls it."""
    model, _, _ = CASES[case]
    mcfg = _mcfg(case)
    variables = weights.convert_flax_variables(tree, mcfg, model)
    if model in VIDEO:
        p = variables["params"]
        if model == "LogisticModel":
            return {"fc": {"kernel": p["fc"]["kernel"].float(), "bias": p["fc"]["bias"].float()}}
        return {name: p[name].float() for name in nr.MOE}
    return get_fast_path(model).prepare(variables, dataclasses.replace(mcfg, sample_random_frames=True),
                                        device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_holds_the_route_prepare_bit_for_bit(root, case):
    ex = _exports(root, case)
    manifest, arrays = nr.read_artifact(ex["port"])
    want = _prepared(case, ex["tree"])
    names = [name for name, _, _ in manifest["weights"]]
    assert manifest["route"] == nr.MODEL_ROUTES[CASES[case][0]]
    assert names == list(nr.ARRAYS[manifest["route"]])
    nbytes = 0
    for name in names:
        got, ref = nr.array_of(arrays, name), nr.array_of(want, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert torch.equal(_bits(got), _bits(ref.contiguous())), name
        nbytes += got.numel() * got.element_size()
    assert os.path.getsize(os.path.join(ex["port"], nr.WEIGHTS_FILE)) == nbytes


def _lines(d):
    with open(os.path.join(d, nr.MANIFEST_FILE)) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("case", list(CASES))
def test_manifest_shares_the_jax_lines(root, case):
    ex = _exports(root, case)
    port, jax_lines = _lines(ex["port"]), _lines(ex["jax"])
    route = nr.MODEL_ROUTES[CASES[case][0]]
    own = nr.ROUTE_LINES[route]
    shared = [line for line in port if line.split()[0] not in own + ("n_weights", "weight")]
    assert shared == [line for line in jax_lines if line.split()[0] not in ("n_weights", "weight")]
    fcfg = CASES[case][2]
    want_input = (f"call_input u8 3 {BATCH} {MAXF} {fcfg.total_size}" if fcfg.frame_features
                  else f"call_input f32 2 {BATCH} {fcfg.total_size}")
    assert want_input in shared and f"output f32 2 {BATCH} {TOP_K}" in shared
    got = {line.split()[0]: line.split()[1:] for line in port if line.split()[0] in own}
    assert list(got) == list(own)
    mcfg = _mcfg(case)
    if "sampling" in got:
        assert got["sampling"] == ["iid" if mcfg.sample_random_frames else "window"]
        assert got["dbof_pooling_method"] == [mcfg.dbof_pooling_method]
    if "nextvlad_groups" in got:
        assert got["nextvlad_groups"] == ["8", "8"] and got["nextvlad_expansion"] == ["2"]
    assert "route" not in {line.split()[0] for line in jax_lines}


@pytest.mark.parametrize("case", FAST + VIDEO)
def test_plain_run_is_the_port_serve_bit_for_bit(root, case):
    ex = _exports(root, case)
    fcfg = CASES[case][2]
    manifest, arrays = nr.read_artifact(ex["port"])
    *_, serve = tem.load_exported_model(ex["port"], prefer_fast=case not in VIDEO, device="cpu")
    for batch in _batches(_records(fcfg)):
        feats, nfs = tem.parse_serialized_records(fcfg, batch)
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        want_indices, want_values = serve(batch)
        np.testing.assert_array_equal(indices.numpy(), want_indices)
        np.testing.assert_array_equal(values.float().numpy(), want_values)
        probs = nr.plain_run(manifest, arrays, feats, nfs, return_probs=True)
        assert probs.shape == (BATCH, SMALL["vocab_size"])
        np.testing.assert_array_equal(torch.gather(probs, 1, indices).numpy(), values.numpy())


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


@pytest.mark.parametrize("case", [c for c in CASES if c not in VIDEO] + list(REMOVE_DIAG))
def test_plain_run_against_the_jax_flax_serve(root, case):
    """Against JAX's flax serve, the graph that its --native_serve exports,
    batch by batch as a server pads them; both draw from key(0)."""
    ex = _exports(root, case)
    fcfg = ALL_CASES[case][2]
    manifest, arrays = nr.read_artifact(ex["port"])
    *_, jax_serve = jem.load_exported_model(ex["jax"], prefer_fast=False)
    for batch in _batches(_records(fcfg)):
        feats, nfs = tem.parse_serialized_records(fcfg, batch)
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        wi, wv = jax_serve(batch)
        _close((indices.numpy(), values.float().numpy()), (np.asarray(wi), np.asarray(wv)), BF16_TOL)


@pytest.mark.parametrize("case", list(REMOVE_DIAG))
def test_gate_w_diagonal_follows_gating_remove_diag(root, case):
    """The written gating weights: the flax leaf's diagonal without the flag
    (in the route's dtype), zeros with it, the rest equal."""
    base = case.removesuffix("_remove_diag")
    _, kept = nr.read_artifact(_exports(root, base)["port"])
    _, removed = nr.read_artifact(_exports(root, case)["port"])
    kept, removed = nr.array_of(kept, "gate_w"), nr.array_of(removed, "gate_w")
    leaf = torch.from_numpy(np.asarray(_exports(root, base)["tree"]["params"]["gating"]["gating_weights"]))
    assert torch.equal(torch.diagonal(kept), torch.diagonal(leaf).to(kept.dtype))
    assert torch.count_nonzero(torch.diagonal(kept)) == kept.shape[0]
    assert torch.count_nonzero(torch.diagonal(removed)) == 0
    off = ~torch.eye(kept.shape[0], dtype=torch.bool)
    assert torch.equal(_bits(removed[off]), _bits(kept[off]))


@pytest.mark.parametrize("case", VIDEO)
def test_video_level_plain_run_against_the_jax_predict_step(root, case):
    import jax

    from learnablepoolingmethods_tpu.core import step as jstep
    from learnablepoolingmethods_tpu.models import create_model as jcreate

    ex = _exports(root, case)
    mcfg, fcfg = _mcfg(case), CASES[case][2]
    jm = jconfig.ModelConfig(**dataclasses.asdict(mcfg))
    predict = jax.jit(jstep.make_predict_step(jcreate(CASES[case][0], jm), jm, False, top_k=TOP_K))
    manifest, arrays = nr.read_artifact(ex["port"])
    for batch in _batches(_records(fcfg)):
        feats, _ = tem.parse_serialized_records(fcfg, batch)
        values, indices = nr.plain_run(manifest, arrays, feats)
        wv, wi = predict(ex["tree"]["params"], ex["tree"]["batch_stats"], feats)
        np.testing.assert_array_equal(indices.numpy(), np.asarray(wi))
        np.testing.assert_allclose(values.numpy(), np.asarray(wv), atol=F32_TOL)


# ---- the tail kernels' plain versions against independent compositions

def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale)


@pytest.mark.parametrize("group,bias_first,n", [(1, False, 2), (1, True, 1), (1, True, 2), (2, True, 4)])
def test_hidden_sum_plain_order(group, bias_first, n):
    parts = [_rand(3, 7, seed=i) for i in range(n)]
    bias = _rand(7, seed=9)
    h, hb = nt.hidden_sum_plain(parts, bias, group, bias_first)
    want = np.zeros((3, 7), np.float32)
    for r in range(3):
        for c in range(7):
            groups = []
            for g in range(0, n, group):
                s = np.float32(parts[g][r, c])
                for j in range(1, group):
                    s = np.float32(s + np.float32(parts[g + j][r, c]))
                groups.append(s)
            acc = np.float32(bias[c]) if bias_first else groups[0]
            for s in groups if bias_first else groups[1:]:
                acc = np.float32(acc + s)
            want[r, c] = acc if bias_first else np.float32(acc + np.float32(bias[c]))
    np.testing.assert_array_equal(h.numpy(), want)
    assert torch.equal(hb, h.to(torch.bfloat16))


@pytest.mark.parametrize("window", [False, True])
def test_frame_stage_plain_against_jax_draws(window):
    """The frames are JAX's draws from key(0) (its sample_random_frames or
    sample_random_sequence on frames coded by their index); each row is the
    bf16 dequantize, ℓ2 in float64, rounded, then the affine rounded."""
    import jax
    import jax.numpy as jnp

    from learnablepoolingmethods_tpu.models import model_utils as jmu

    rng = np.random.default_rng(5)
    b, f, dt, s = 5, 7, 16, 4
    x = rng.integers(0, 256, (b, f, dt), dtype=np.uint8)
    nf = np.array([7, 1, 3, 6, 5], np.int32)
    coded = jnp.broadcast_to(jnp.arange(f, dtype=jnp.float32)[None, :, None], (b, f, 1))
    draw = jmu.sample_random_sequence if window else jmu.sample_random_frames
    idx = np.asarray(draw(coded, jnp.asarray(nf), s, jax.random.key(0)))[:, :, 0].astype(np.int64)
    scale, bias = _rand(dt, seed=1, scale=0.1) + 1, _rand(dt, seed=2, scale=0.1)
    got = nt.frame_stage_plain(torch.from_numpy(x), prng.key(0), torch.from_numpy(nf), s, scale, bias, window)
    bare = nt.frame_stage_plain(torch.from_numpy(x), prng.key(0), torch.from_numpy(nf), s, window=window)
    rows = torch.from_numpy(x[np.arange(b)[:, None], idx]).to(torch.bfloat16)
    deq = rows * torch.tensor(4 / 255, dtype=torch.bfloat16) + torch.tensor(4 / 512 - 2, dtype=torch.bfloat16)
    d64 = deq.double()
    y = (d64 / torch.sqrt(torch.clamp((d64 ** 2).sum(-1, keepdim=True), min=1e-12))).to(torch.bfloat16)
    assert (bare.float() - y.float()).abs().max().item() <= 2 ** -8
    z = (y.double() * scale.double() + bias.double()).to(torch.bfloat16)
    assert (got.float() - z.float()).abs().max().item() <= 2 ** -7


def test_epilogues_pooling_and_rounding_plain():
    y, bias = _rand(6, 5, seed=3, scale=4.0), _rand(5, seed=4)
    z = y.double() + bias.double()
    np.testing.assert_allclose(nt.bias_sigmoid_plain(y, bias).numpy(), (1 / (1 + torch.exp(-z))).numpy(), atol=1e-7)
    np.testing.assert_allclose(nt.bias_relu6_plain(y, bias).numpy(), z.clamp(0, 6).numpy(), atol=1e-6)
    assert nt.bias_relu6_plain(y, bias, torch.bfloat16).dtype == torch.bfloat16
    act = _rand(2, 3, 5, seed=5)
    assert torch.equal(nt.frame_pool_plain(act, "max"), torch.stack([act[:, s] for s in range(3)]).max(0).values
                       .to(torch.bfloat16))
    mean = (act.double().sum(1) / 3).to(torch.bfloat16)
    assert (nt.frame_pool_plain(act, "average").float() - mean.float()).abs().max().item() <= 2 ** -8
    with pytest.raises(ValueError, match="pooling method"):
        nt.frame_pool_plain(act, "sum")


def test_row_l2_plain_with_and_without_the_affine():
    x = _rand(6, 5, seed=6)
    x[2] = 0  # a zero row stays zero (ε on Σx²)
    x64 = x.double()
    unit = x64 / torch.sqrt(torch.clamp((x64 ** 2).sum(-1, keepdim=True), min=1e-12))
    np.testing.assert_allclose(nt.row_l2_plain(x, dtype=torch.float32).numpy(), unit.numpy(), atol=1e-7)
    assert (nt.row_l2_plain(x).float() - unit.float()).abs().max().item() <= 2 ** -8
    scale, bias = _rand(10, seed=7), _rand(10, seed=8)  # two rows of 5: row r takes (r mod 2)·5 …
    want = torch.stack([unit[r] * scale[(r % 2) * 5:(r % 2) * 5 + 5].double()
                        + bias[(r % 2) * 5:(r % 2) * 5 + 5].double() for r in range(6)])
    assert (nt.row_l2_plain(x, scale, bias).float() - want.float()).abs().max().item() <= 2 ** -6


def test_nextvlad_assign_and_residual_plain():
    r, g, k, b, dp = 6, 2, 3, 2, 4
    prod, gprod = _rand(r, g * k, seed=10), _rand(r, g, seed=11)
    scale, bias = _rand(g * k, seed=12), _rand(g * k, seed=13)
    assign, assign_bf16 = nt.nextvlad_assign_plain(prod, scale, bias, gprod)
    want = np.zeros((r, g, k))
    for i in range(r):
        for j in range(g):
            logits = prod[i, j * k:(j + 1) * k].double() * scale[j * k:(j + 1) * k].double() \
                + bias[j * k:(j + 1) * k].double()
            e = torch.exp(logits - logits.max())
            want[i, j] = (e / e.sum() / (1 + torch.exp(-gprod[i, j].double()))).numpy()
    np.testing.assert_allclose(assign.numpy(), want, atol=1e-6)
    assert torch.equal(assign_bf16, assign.to(torch.bfloat16))
    agg, c2 = _rand(b, k, dp, seed=14), _rand(k, dp, seed=15)
    per_video = assign.reshape(b, r // b, g, k)
    out = nt.nextvlad_residual_plain(agg, per_video, c2)
    sums = per_video.double().sum(dim=(1, 2))
    np.testing.assert_allclose(out.numpy(), (agg.double() - sums[:, :, None] * c2.double()).numpy(), atol=1e-6)


def test_nextvlad_pool_traces_the_steps_the_runner_reads(root):
    """``nextvlad_pool``'s trace holds each step in the shape and dtype of
    the runner's buffer of that name (``NativeExecutable.read``:
    ``chip_smoke.py#nextvlad_trace`` compares them on the card), and
    tracing leaves the product as it was."""
    from learnablepoolingmethods_torch.ops.fast_infer import matmul_f32
    from learnablepoolingmethods_torch.ops.fast_lf import nextvlad_pool

    fp = _prepared("NeXtVLADModel", _exports(root, "NeXtVLADModel")["tree"])
    b, s = 3, MAXF
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(b, s, LCFG.feature_sizes[0]))).to(torch.bfloat16)
    entry = fp["mods"][0]
    k, dp = entry["c2"].shape
    g, width = entry["wg"].shape[1], entry["cluster"].shape[1]
    trace = {}
    part = nextvlad_pool(x, entry, torch.bfloat16, trace)
    assert torch.equal(part, nextvlad_pool(x, entry))
    want = {"xt": ((b * s, width), torch.bfloat16), "assign": ((b * s * g, k), torch.float32),
            "residual": ((b, k, dp), torch.float32), "vlad": ((b, k * dp), torch.bfloat16)}
    assert {n: (tuple(t.shape), t.dtype) for n, t in trace.items()} == want
    assert torch.equal(matmul_f32(trace["vlad"], entry["w1"]), part)
    assert torch.equal(trace["xt"], matmul_f32(x.reshape(b * s, -1), entry["cluster"]).to(torch.bfloat16))


def test_rows_on_the_runners_path_are_built_once():
    """Rows 1, 2, 5, 6 and 7 are compiled into the runner's library only:
    their wrappers load it (``kernel_build.HOME``) and no library of their
    own is built; a source that no build compiled with ``-Xptxas -v`` has no
    report."""
    from learnablepoolingmethods_torch.ops import kernel_build as kb

    rows = ("fused_frontend", "netvlad_fused", "softdbow_fused", "netfv_fused", "masked_attention")
    assert {row: kb.HOME[row] for row in rows} == dict.fromkeys(rows, nr.LIBRARY)
    assert not set(rows) & set(kb.KERNEL_SOURCES)
    assert [p.stem for p in kb.sources(nr.LIBRARY)] == [nr.LIBRARY, *rows]
    assert kb.ptxas_report("netvlad_fused") is None


# ---- refusals

OUTSIDE_THE_ROUTES = {
    "no_dbof_batch_norm": ("DbofModel", dict(dbof_add_batch_norm=False), FCFG),
    "video_model_on_frames": ("LogisticModel", {}, FCFG),
    "frame_model_on_videos": ("NetFVModelLF", {}, VCFG),
    "lf_window": ("NetRVLADModelLF", dict(sample_random_frames=False), LCFG),
    "lf_relu": ("SoftDbofModelLF", dict(netvlad_relu=True), LCFG),
    "video_bf16": ("MoeModel", dict(compute_dtype="bfloat16"), VCFG),
    # every model of the registry has a route since item 14c.5
    # (tests/test_torch_native_attention_routes.py,
    # tests/test_torch_native_rnn_routes.py): what stays outside is the
    # configs that those routes refuse
    "attention": ("AttentionPoolingModel", dict(attention_hidden_size=16, attention_heads=2,
                                                transformer_ff_size=8, attention_cluster_size=2,
                                                compute_dtype="bfloat16"), FCFG),
    "rnn": ("LstmModel", dict(lstm_cells=8), VCFG),
    "frame_level_logistic": ("FrameLevelLogisticModel", dict(compute_dtype="bfloat16"), FCFG),
    "gru": ("GruModel", dict(gru_cells=8), VCFG),
    "transformer_no_gating": ("TransformerEncoderModel", dict(attention_hidden_size=16, attention_heads=2,
                                                              transformer_ff_size=8, gating=False), FCFG),
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


def _edited(src, dst, drop=None, replace=None):
    import shutil

    shutil.copytree(src, dst)
    lines = _lines(dst)
    if drop:
        lines = [line for line in lines if line.split()[0] != drop]
    if replace:
        lines = [replace.get(line.split()[0], line) for line in lines]
    with open(os.path.join(dst, nr.MANIFEST_FILE), "w") as f:
        f.write("\n".join(lines) + "\n")
    return dst


@pytest.fixture(scope="module")
def lpm_serve(tmp_path_factory):
    binary = tmp_path_factory.mktemp("lpm_serve_fake") / "lpm_serve"
    out = subprocess.run(nr.serving_binary_command(FAKE_RUNNER, binary), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return str(binary)


@pytest.mark.parametrize("edit,message", [
    (dict(drop="sampling"), "route fast_dbof needs the line 'sampling'"),
    (dict(drop="dbof_pooling_method"), "route fast_dbof needs the line 'dbof_pooling_method'"),
    (dict(replace={"route": "route fast_dbof_v2"}), "unknown route 'fast_dbof_v2'"),
])
def test_a_manifest_without_its_route_lines_is_refused(root, tmp_path, lpm_serve, edit, message):
    d = _edited(_exports(root, "DbofModel")["port"], str(tmp_path / "edited"), **edit)
    with pytest.raises(ValueError, match=message):
        nr.read_manifest(d)
    check = subprocess.run([lpm_serve, f"--export_dir={d}", "--check"], capture_output=True, text=True, timeout=60)
    assert check.returncode != 0 and message in check.stderr, check.stderr


def test_a_video_level_artifact_takes_no_frame_counts(root):
    exe = nr.NativeExecutable(nr.read_manifest(_exports(root, "LogisticModel")["port"]))  # no runner loaded
    feats, nfs = tem.parse_serialized_records(VCFG, _records(VCFG)[:BATCH])
    assert nfs is None and feats.dtype == np.float32
    with pytest.raises(ValueError, match="takes no frame counts"):
        exe.run(feats, np.zeros(BATCH, np.int32))
    with pytest.raises(ValueError, match="pad the batch to the exported batch size 4"):
        exe.run(feats[:3])
    with pytest.raises(RuntimeError, match="closed"):
        exe.run(feats)


# ---- lpm_serve's video-level branch over the stand-in runner

def _expected(fcfg, records):
    """The stand-in's (classes, scores) of each record's parsed f32 row."""
    feats, _ = tem.parse_serialized_records(fcfg, records)
    out = []
    for row in feats:
        s = int(np.floor(np.float32(256) * row).astype(np.int64).sum()) % 9973
        out.append(([(s + 7 * j) % 97 for j in range(TOP_K)], [s / 16384 - j / 64 for j in range(TOP_K)]))
    return out


def test_lpm_serve_parses_video_level_records(root, lpm_serve):
    import http.client
    import re

    export_dir = _exports(root, "LogisticModel")["port"]
    check = subprocess.run([lpm_serve, f"--export_dir={export_dir}", "--check"], capture_output=True, text=True,
                           timeout=60)
    assert check.returncode == 0, check.stderr
    (pred,) = json.loads(check.stdout)["predictions"]
    assert pred["classes"] == [7 * j for j in range(TOP_K)]  # the empty record parses to a row of zeros
    records = _records(VCFG)
    proc = subprocess.Popen([lpm_serve, f"--export_dir={export_dir}", "--port=0"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        port = int(re.search(r"serving .* on :(\d+)", proc.stdout.readline()).group(1))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predict", body=frame_records(records))
        resp = conn.getresponse()
        assert resp.status == 200
        preds = json.loads(resp.read())["predictions"]
        conn.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert len(preds) == len(records)
    for i, (p, (classes, scores)) in enumerate(zip(preds, _expected(VCFG, records))):
        assert p["video_index"] == i and p["classes"] == classes
        np.testing.assert_allclose(p["scores"], scores, atol=1e-6)
