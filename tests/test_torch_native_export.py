"""The native runner's artifact (export_model.py with with_stablehlo=True)
and the runner's plain version (core/native_runtime.py#plain_run) against
the fast route and the JAX package, at a small Willow-shaped config.

- The arrays of weights.bin are prepare_fast_params(device="cpu")'s bit for
  bit; the manifest's lines that the JAX package also writes equal its
  lines (JAX's own with_stablehlo export of the same tree on the CPU); JAX's
  loader reads the port's native export.
- plain_run equals the port's fast serve bit for bit, and is within 3e-2
  (tests/test_torch_fast_infer.py's and tests/test_torch_serving.py's bf16
  tolerance) of JAX's fast serve and of JAX's flax serve, the graph that
  JAX's --native_serve runs; both draw their frames from key(0) as the
  runner does.  JAX's native_runtime is not called: its g++ build writes
  in place and races under xdist.
- The refusals: a model or config outside the route (ROADMAP item 14c), a
  JAX export, the CPU, --native_serve with --fast_serve or --int8_hidden, a
  batch of another size, a truncated weights.bin.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from learnablepoolingmethods_torch import export_model as tem
from learnablepoolingmethods_torch import serving
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import native_runtime as nr
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.ops.fast_infer import prepare_fast_params

from learnablepoolingmethods_tpu import config as jconfig
from learnablepoolingmethods_tpu import export_model as jem

BF16_TOL = 3e-2
FCFG = FeatureConfig(("rgb", "audio"), (1024, 128), True, 10)
MCFG = ModelConfig(vocab_size=12, netvlad_cluster_size=4, netvlad_hidden_size=8, iterations=6)
BATCH, TOP_K = 4, 5
PORT_KEYS = ("route", "sampling_key", "iterations", "moe_num_mixtures")


def _tree(mcfg=MCFG, fcfg=FCFG, model="NetVLADModelLF"):
    """A seeded tree with BN statistics off their init; NetVLAD's hidden FC
    and MoE scaled up, so that scores spread (as tests/test_torch_export.py
    does: frames from another key would then move them past 3e-2)."""
    tree = weights.init_variables_np(mcfg, fcfg, seed=3, model_name=model)

    def shifted(stats):
        return {k: shifted(v) if isinstance(v, dict) else v + np.float32(0.1) for k, v in stats.items()}

    tree["batch_stats"] = shifted(tree["batch_stats"])
    if model == "NetVLADModelLF":
        params = tree["params"]
        params["hidden1_weights"] = params["hidden1_weights"] * np.float32(3)
        for name in ("gates_kernel", "experts_kernel"):
            params["MoeModel_0"][name] = params["MoeModel_0"][name] * np.float32(3)
    return tree


def _records():
    """Frame-level records: more and fewer frames than max_frames, one frame,
    audio shorter than rgb, and no audio list at all."""
    rng = np.random.default_rng(1)
    out = []
    for i, (n_rgb, n_aud) in enumerate(((10, 10), (3, 3), (14, 14), (1, 1), (7, 4), (5, 0))):
        rgb = rng.integers(0, 256, (n_rgb, 1024), dtype=np.uint8)
        aud = rng.integers(0, 256, (n_aud, 128), dtype=np.uint8)
        names = ("rgb", "audio") if n_aud else ("rgb", "not_audio")
        out.append(fixtures.encode_frame_sequence_example(b"v%d" % i, [1], rgb, aud, feature_names=names))
    return out


def _batches(records):
    """The batches a server runs: chunks of BATCH padded with their last."""
    for start in range(0, len(records), BATCH):
        chunk = records[start:start + BATCH]
        yield chunk + [chunk[-1]] * (BATCH - len(chunk))


def _jax_configs(mcfg, fcfg):
    import dataclasses

    return jconfig.ModelConfig(**dataclasses.asdict(mcfg)), jconfig.FeatureConfig(**dataclasses.asdict(fcfg))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The same tree exported with with_stablehlo=True by both packages."""
    root = tmp_path_factory.mktemp("native")
    tree = _tree()
    jm, jf = _jax_configs(MCFG, FCFG)
    jax_dir = jem.export_model(str(root / "jax"), "NetVLADModelLF", jm, jf, tree["params"], tree["batch_stats"],
                               top_k=TOP_K, with_stablehlo=True, stablehlo_batch_size=BATCH)
    assert not os.path.exists(os.path.join(jax_dir, "stablehlo_error.txt"))
    port_dir = tem.export_model(str(root / "port"), "NetVLADModelLF", MCFG, FCFG, tree["params"],
                                tree["batch_stats"], top_k=TOP_K, with_stablehlo=True, stablehlo_batch_size=BATCH)
    return {"tree": tree, "jax": jax_dir, "port": port_dir}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def test_artifact_holds_the_fast_params_bit_for_bit(exports):
    manifest, arrays = nr.read_artifact(exports["port"])
    fp = prepare_fast_params(weights.convert_flax_variables(exports["tree"], MCFG), MCFG, device="cpu")
    assert [name for name, _, _ in manifest["weights"]] == list(nr.ARRAYS[nr.ROUTE])
    nbytes = 0
    for name in nr.ARRAYS[nr.ROUTE]:
        got, want = nr.array_of(arrays, name), nr.array_of(fp, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(_bits(got), _bits(want)), name
        nbytes += got.numel() * got.element_size()
    assert os.path.getsize(os.path.join(exports["port"], nr.WEIGHTS_FILE)) == nbytes


def test_manifest_shares_the_jax_lines(exports):
    def lines(d):
        with open(os.path.join(d, nr.MANIFEST_FILE)) as f:
            return f.read().splitlines()

    port, jax_lines = lines(exports["port"]), lines(exports["jax"])
    shared = [line for line in port if line.split()[0] not in PORT_KEYS + ("n_weights", "weight")]
    assert shared == [line for line in jax_lines if line.split()[0] not in ("n_weights", "weight")]
    assert "call_input u8 3 4 10 1152" in shared and "output f32 2 4 5" in shared
    own = {line.split()[0]: line.split()[1:] for line in port if line.split()[0] in PORT_KEYS}
    assert own == {"route": [nr.ROUTE], "sampling_key": ["0", "0"], "iterations": ["6"], "moe_num_mixtures": ["2"]}
    assert "route" not in {line.split()[0] for line in jax_lines}


def test_the_jax_loader_reads_the_port_native_export(exports):
    records = _records()
    *_, jax_serve = jem.load_exported_model(exports["port"], prefer_fast=True)
    *_, want = jem.load_exported_model(exports["jax"], prefer_fast=True)
    (gi, gv), (wi, wv) = jax_serve(records), want(records)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)


def test_plain_run_is_the_fast_route_bit_for_bit(exports):
    manifest, arrays = nr.read_artifact(exports["port"])
    *_, serve = tem.load_exported_model(exports["port"], prefer_fast=True, device="cpu")
    for batch in _batches(_records()):
        feats, nfs = tem.parse_serialized_records(FCFG, batch)
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        want_indices, want_values = serve(batch)
        np.testing.assert_array_equal(indices.numpy(), want_indices)
        np.testing.assert_array_equal(values.float().numpy(), want_values)
        probs = nr.plain_run(manifest, arrays, feats, nfs, return_probs=True)
        assert probs.shape == (BATCH, MCFG.vocab_size)
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


@pytest.mark.parametrize("jax_route", ["fast", "flax"])
def test_plain_run_against_the_jax_serves(exports, jax_route):
    """Against JAX's fast serve and its flax serve (JAX's --native_serve
    graph), batch by batch as a server pads them."""
    manifest, arrays = nr.read_artifact(exports["port"])
    *_, jax_serve = jem.load_exported_model(exports["jax"], prefer_fast=jax_route == "fast")
    for batch in _batches(_records()):
        feats, nfs = tem.parse_serialized_records(FCFG, batch)
        values, indices = nr.plain_run(manifest, arrays, feats, nfs)
        wi, wv = jax_serve(batch)
        _close((indices.numpy(), values.float().numpy()), (np.asarray(wi), np.asarray(wv)), BF16_TOL)


# DbofModel and LogisticModel have routes of their own since item 14c.1
# (tests/test_torch_native_routes.py): what stays outside them here is DBoF
# without its batch norms and a video-level model on frame-level features
OUTSIDE_THE_ROUTE = {
    "DbofModel": ("DbofModel", dict(dbof_cluster_size=8, dbof_hidden_size=8, dbof_add_batch_norm=False), FCFG),
    "LogisticModel": ("LogisticModel", {}, FCFG),
    "netvlad_relu": ("NetVLADModelLF", dict(netvlad_relu=True), FCFG),
    "presampled": ("NetVLADModelLF", dict(presampled=True), FCFG),
    "contiguous_frames": ("NetVLADModelLF", dict(sample_random_frames=False), FCFG),
}


@pytest.mark.parametrize("case", list(OUTSIDE_THE_ROUTE))
def test_exports_outside_the_route_raise_naming_item_14c(tmp_path, case):
    model, overrides, fcfg = OUTSIDE_THE_ROUTE[case]
    mcfg = ModelConfig(**{**dict(vocab_size=12, netvlad_cluster_size=4, netvlad_hidden_size=8, iterations=6),
                          **overrides})
    tree = weights.init_variables_np(mcfg, fcfg, seed=0, model_name=model)
    export_dir = str(tmp_path / "e")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
        tem.export_model(export_dir, model, mcfg, fcfg, tree["params"], tree["batch_stats"], with_stablehlo=True)
    assert not os.path.exists(export_dir)


def test_a_jax_native_export_is_refused(exports):
    for load in (nr.read_manifest, nr.read_artifact,
                 lambda d: tem.load_exported_native(d, device="cuda"),
                 lambda d: serving.ModelServer(d, BATCH, native=True)):
        with pytest.raises(ValueError, match="re-export it through learnablepoolingmethods_torch"):
            load(exports["jax"])


def test_native_serve_refuses_the_cpu_and_the_fast_flags(exports):
    port = exports["port"]
    for load in (lambda: tem.load_exported_native(port, device="cpu"),
                 lambda: nr.NativeExecutable.from_export_dir(port, device="cpu"),
                 lambda: serving.ModelServer(port, BATCH, native=True, device="cpu")):
        with pytest.raises(ValueError, match="runs on the card"):
            load()
    for flags in (dict(fast_serve=True), dict(int8_hidden=True)):
        with pytest.raises(ValueError, match="exclusive with --fast_serve/--int8_hidden"):
            serving.ModelServer(port, BATCH, native=True, device="cpu", **flags)
    with pytest.raises(ValueError, match="exclusive with --fast_serve"):
        serving.main([f"--export_dir={port}", "--native_serve", "--fast_serve"])


def test_a_batch_of_another_size_asks_to_pad(exports):
    exe = nr.NativeExecutable(nr.read_manifest(exports["port"]))  # shape checks only: no runner loaded
    assert (exe.batch_size, exe.top_k, exe.vocab_size) == (BATCH, TOP_K, MCFG.vocab_size)
    feats, nfs = tem.parse_serialized_records(FCFG, _records()[:3])
    with pytest.raises(ValueError, match="pad the batch to the exported batch size 4"):
        exe.run(feats, nfs)
    feats, nfs = tem.parse_serialized_records(FCFG, _records()[:4])
    with pytest.raises(ValueError, match="pad the batch"):
        exe.probs(feats.astype(np.float32), nfs)
    with pytest.raises(RuntimeError, match="closed"):
        exe.run(feats, nfs)


def test_a_truncated_weights_file_is_refused(exports, tmp_path):
    copy = str(tmp_path / "copy")
    shutil.copytree(exports["port"], copy)
    path = os.path.join(copy, nr.WEIGHTS_FILE)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 2)
    with pytest.raises(ValueError, match="re-export the artifact"):
        nr.read_artifact(copy)
