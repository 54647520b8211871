"""The plain versions of the port's NetFV and SoftDBoW kernels ≡ the JAX
package's Pallas kernels (interpret mode) and their jnp references on the
CPU, at the shapes of tests/unit/test_netfv_pallas.py and
tests/unit/test_softdbow_pallas.py.  A CPU tensor takes the plain version;
any other device goes to the kernel's checks, never to the plain version."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import netfv_pallas as jfv
from learnablepoolingmethods_tpu.ops import softdbow_pallas as jbow
from learnablepoolingmethods_torch.ops.netfv_fused import netfv_fused, netfv_reference
from learnablepoolingmethods_torch.ops import softdbow_fused as bow_mod
from learnablepoolingmethods_torch.ops.softdbow_fused import softdbow_fused, softdbow_reference

# bf16 input, bf16 output: both sides compute in f32 from the same bf16
# values and round the output once, so they differ by summation order and
# at most one bf16 step of the output (2⁻⁸ relative)
BF16_ATOL = 4e-3


def _netfv_inputs(rng, b=3, f=12, d=256, k=8):
    """The inputs of tests/unit/test_netfv_pallas.py#_inputs."""
    x = rng.normal(scale=0.2, size=(b, f, d)).astype(np.float32)
    c = rng.normal(scale=0.05, size=(d, k)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32)
    bias = rng.normal(scale=0.1, size=(k,)).astype(np.float32)
    c2 = rng.normal(scale=0.05, size=(d, k)).astype(np.float32)
    covar = np.square(rng.normal(scale=0.3, size=(d, k))).astype(np.float32) + 1e-6
    return x, c, scale, bias, c2, covar


def _softdbow_inputs(f):
    """The inputs of tests/unit/test_softdbow_pallas.py#_inputs."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, (3, f, 16)).astype(np.float32)
    c = rng.normal(0, 0.25, (16, 24)).astype(np.float32)
    scale = rng.normal(1, 0.1, (24,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (24,)).astype(np.float32)
    return x, c, scale, bias


def _torch(args, x_dtype=torch.float32):
    x, *rest = args
    return (torch.from_numpy(x).to(x_dtype), *(torch.from_numpy(a) for a in rest))


def _jax(args, x_dtype=jnp.float32):
    x, *rest = args
    return (jnp.asarray(x, x_dtype), *(jnp.asarray(a) for a in rest))


def test_netfv_matches_jax_kernel_and_reference_f32(rng):
    args = _netfv_inputs(rng)
    got = netfv_fused(*_torch(args))  # a CPU tensor: the plain version
    for want in (jfv.netfv_fused(*_jax(args), interpret=True), jfv.netfv_reference(*_jax(args))):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # in f32 the kernels' rounding points change nothing
    for a, b in zip(got, netfv_reference(*_torch(args), kernel_rounding=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_netfv_bf16_matches_jax(rng):
    """bf16 frames: the plain version against the JAX reference, and with the
    kernels' rounding points (A and X² in bf16) against the JAX kernel."""
    args = _netfv_inputs(rng)
    want_ref = jfv.netfv_reference(*_jax(args, jnp.bfloat16))
    want_kernel = jfv.netfv_fused(*_jax(args, jnp.bfloat16), interpret=True)
    got_ref = netfv_reference(*_torch(args, torch.bfloat16))
    got_kernel = netfv_reference(*_torch(args, torch.bfloat16), kernel_rounding=True)
    for got, want in ((got_ref, want_ref), (got_kernel, want_kernel)):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=BF16_ATOL)


@pytest.mark.parametrize("f", [16, 7])  # F=16 takes the TPU kernel's frame split, 7 does not
def test_softdbow_matches_jax_kernel_and_reference(f):
    args = _softdbow_inputs(f)
    if f == 16:
        assert f % jbow._F_SPLIT == 0 and (f // jbow._F_SPLIT) % 8 == 0
    got = softdbow_fused(*_torch(args))
    assert got.shape == (3, 24) and got.dtype == torch.float32
    for want in (jbow.softdbow_fused(*_jax(args), interpret=True), jbow.softdbow_reference(*_jax(args))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_softdbow_bf16_matches_jax():
    """bf16 frames and clusters: products exact in f32, sums in f32, so the
    f32 tolerance holds."""
    args = _softdbow_inputs(16)
    got = softdbow_reference(*_torch(args, torch.bfloat16))
    want = jbow.softdbow_fused(*_jax(args, jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_softdbow_reference_matches_numpy():
    x, c, scale, bias = _softdbow_inputs(6)
    logits = np.einsum("bfd,dk->bfk", x, c) * scale + bias
    e = np.exp(logits - logits.max(-1, keepdims=True))
    want = (e / e.sum(-1, keepdims=True)).sum(1)
    np.testing.assert_allclose(softdbow_reference(*_torch((x, c, scale, bias))).numpy(), want, atol=1e-5)


def test_wrappers_take_the_plain_version_only_on_the_cpu(rng):
    """A tensor on another device than the CPU reaches the kernel's checks
    (here: the device), and the launch counters move only on a launch."""
    fv = _torch(_netfv_inputs(rng, b=2, f=5, d=16, k=4))
    bow = _torch(_softdbow_inputs(5))
    before = (netfv_fused.launches, softdbow_fused.launches)
    netfv_fused(*fv)
    softdbow_fused(*bow)
    assert (netfv_fused.launches, softdbow_fused.launches) == before
    with pytest.raises(ValueError, match="unsupported device meta"):
        netfv_fused(fv[0].to("meta"), *fv[1:])
    with pytest.raises(ValueError, match="unsupported device meta"):
        softdbow_fused(bow[0].to("meta"), *bow[1:])


@pytest.mark.parametrize("s", [1, 30, 150])
@pytest.mark.parametrize("k", [10, 150, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softdbow_workspace_matches_the_c_entry_point(s, k, dtype):
    """lpm_softdbow_fused's scratch: after bow come ws_max and ws_sum, one
    (max, Σ exp) partial per frame row and 128-cluster tile (the tile width
    of csrc/softdbow_fused.cu), then ws_logits, every logit for bf16 frames
    and nothing for f32; the ctypes signature has one pointer for each."""
    src = (Path(bow_mod.__file__).parents[1] / "csrc" / "softdbow_fused.cu").read_text()
    assert int(re.search(r"constexpr int kBowClusters = (\d+);", src).group(1)) == bow_mod.CLUSTER_TILE
    entry = re.search(r'extern "C" int lpm_softdbow_fused\(([^)]*)\)', src).group(1)
    params = [p.split()[-1].lstrip("*") for p in entry.split(",")]
    shapes = bow_mod.workspace_shapes(7, s, k, dtype)
    assert params[params.index("bow") + 1:params.index("B")] == list(shapes)
    assert len(bow_mod._ARGTYPES) == len(params)
    tiles = -(-k // 128)
    assert shapes["ws_max"] == shapes["ws_sum"] == (7 * s, tiles)
    assert (tiles - 1) * 128 < k <= tiles * 128
    assert shapes["ws_logits"] == ((7 * s, k) if dtype == torch.bfloat16 else (0,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softdbow_cpu_wrapper_takes_the_plain_version(dtype):
    x, c, scale, bias = _torch(_softdbow_inputs(5), dtype)
    before = softdbow_fused.launches
    got = softdbow_fused(x, c, scale, bias)
    torch.testing.assert_close(got, softdbow_reference(x, c, scale, bias), rtol=0, atol=0)
    assert softdbow_fused.launches == before
