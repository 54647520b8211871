"""The port's masked attention (ops/masked_attention.py) ≡ the JAX package's
on the CPU: the plain version, which rounds where the TPU kernel and the
bf16 CUDA kernel round (the normalised weights to bf16 before ·V, the
output once), against JAX's attention_reference and against its Pallas
kernel masked_attention_fused in interpret mode, in f32 and with bf16
inputs, on rows whose num_frames is 0, 1 and F; the CPU wrapper takes the
plain version; and the checks that guard the CUDA kernel's operands."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import fast_transformer as jft
from learnablepoolingmethods_torch.ops import masked_attention as ma

B, F = 4, 7


def _inputs(seed, heads, hd, dtype, f=F):
    """qkv [B, f, 3·H·hd] at the scale of the config's logits (a few units)
    and a mask whose rows hold 0, 1, f and f − 2 valid frames."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(scale=2.0, size=(B, f, 3 * heads * hd)).astype(np.float32)
    if dtype == "bfloat16":
        qkv = np.array(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))
    nf = np.array([0, 1, f, max(f - 2, 0)])
    mask = (np.arange(f)[None, :] < nf[:, None]).astype(np.float32)
    return qkv, mask


def _jax(qkv, mask, heads, dtype, interpret):
    x = jnp.asarray(qkv, jnp.dtype(dtype))
    if interpret:
        return np.asarray(jft.masked_attention_fused(x, jnp.asarray(mask), heads, interpret=True)
                          .astype(jnp.float32))
    d = qkv.shape[-1] // 3
    return np.asarray(jft.attention_reference(x[..., :d], x[..., d:2 * d], x[..., 2 * d:],
                                              jnp.asarray(mask), heads).astype(jnp.float32))


def _torch(qkv, mask, heads, dtype):
    t = torch.from_numpy(qkv).to(getattr(torch, dtype))
    return ma.masked_attention_plain(t, torch.from_numpy(mask), heads)


def bf16_step(x):
    """The spacing of bf16 values at |x|: 2^(⌊log₂|x|⌋ − 7)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("interpret", [False, True], ids=["reference", "pallas_interpret"])
@pytest.mark.parametrize("heads,hd", [(2, 8), (1, 16)])
def test_plain_f32_matches_jax(interpret, heads, hd):
    qkv, mask = _inputs(0, heads, hd, "float32")
    want = _jax(qkv, mask, heads, "float32", interpret)
    got = _torch(qkv, mask, heads, "float32")
    assert got.dtype == torch.float32 and got.shape == (B, F, heads * hd)
    # f32 throughout, sums in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("interpret", [False, True], ids=["reference", "pallas_interpret"])
def test_plain_bf16_matches_jax_at_the_bf16_gate(interpret):
    """bf16 inputs through both, compared in f32 at the bf16 gate of
    chip_smoke.py (1e-2·max|ref| + 2e-2·|ref|): the weights are rounded to
    bf16 before ·V in both, the output once more."""
    qkv, mask = _inputs(1, 2, 8, "bfloat16")
    want = _jax(qkv, mask, 2, "bfloat16", interpret)
    got = _torch(qkv, mask, 2, "bfloat16")
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 1e-2 * np.abs(want).max() + 2e-2 * np.abs(want)).all(), diff.max()


@pytest.mark.parametrize("interpret", [False, True], ids=["reference", "pallas_interpret"])
@pytest.mark.parametrize("heads,hd,f", [(2, 8, F), (1, 16, 70)])
def test_kernel_rounding_bf16_matches_jax_at_the_bf16_gate(interpret, heads, hd, f):
    """The bf16 kernel's rounding points, which the plain version now takes
    (the normalised weights rounded to bf16 for ·V, no division after it),
    against the JAX rounding points at chip_smoke.py's bf16 gate."""
    qkv, mask = _inputs(4, heads, hd, "bfloat16", f)
    want = _jax(qkv, mask, heads, "bfloat16", interpret)
    got = _torch(qkv, mask, heads, "bfloat16")
    assert got.dtype == torch.bfloat16 and got.shape == (B, f, heads * hd)
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 1e-2 * np.abs(want).max() + 2e-2 * np.abs(want)).all(), diff.max()


@pytest.mark.parametrize("heads,hd,f,seed", [(2, 8, F, 1), (1, 16, 70, 4), (2, 32, 40, 6)])
def test_plain_bf16_rounds_where_the_pallas_kernel_rounds(heads, hd, f, seed):
    """bf16 inputs: the plain version against the Pallas kernel in
    interpret mode, entry by entry, within one bf16 step of the larger of
    the two everywhere and equal on at least 99 % of the entries.  The
    earlier rounding (the unnormalised exp rounded, the sum divided out
    after ·V) parts from it by up to 300 steps and on 15-27 % of the
    entries at these shapes."""
    qkv, mask = _inputs(seed, heads, hd, "bfloat16", f)
    want = _jax(qkv, mask, heads, "bfloat16", interpret=True)
    got = _torch(qkv, mask, heads, "bfloat16").float().numpy()
    diff = np.abs(got - want)
    steps = diff / bf16_step(np.maximum(np.abs(got), np.abs(want)))
    equal = float((diff == 0).mean())
    print(f"F={f} H={heads} hd={hd}: {equal:.6f} of the entries equal, at most {steps.max():.2f} bf16 steps")
    assert steps.max() <= 1.0 and equal >= 0.99, (steps.max(), equal)


@pytest.mark.parametrize("heads,hd", [(2, 8), (1, 16), (3, 40)])
def test_kernel_rounding_f32_equals_the_default(heads, hd):
    """In f32 the kernel rounds nothing: the plain version (the f32 FMA
    kernel's twin) against the Pallas kernel in interpret mode, at f32
    rounding."""
    qkv, mask = _inputs(5, heads, hd, "float32")
    np.testing.assert_allclose(_torch(qkv, mask, heads, "float32").numpy(),
                               _jax(qkv, mask, heads, "float32", interpret=True), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_masked_row_is_the_mean_of_v(dtype):
    """num_frames 0: every key takes −1e9, so the weights are uniform over
    all F rows, not NaN and not zero (flax's MHA gives the same row)."""
    qkv, mask = _inputs(2, 2, 8, dtype)
    got = _torch(qkv, mask, 2, dtype).float().numpy()
    v = qkv[0, :, 2 * 16:]
    # bf16: the weight 1/F and the output are rounded once each
    tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(v).max()
    np.testing.assert_allclose(got[0], np.broadcast_to(v.mean(axis=0), (F, 16)), atol=tol)
    # one valid frame: every query takes that frame's v
    np.testing.assert_allclose(got[1], np.broadcast_to(qkv[1, 0, 2 * 16:], (F, 16)), atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_the_plain_version(dtype):
    qkv, mask = _inputs(3, 2, 8, "float32")
    t = torch.from_numpy(qkv).to(dtype)
    before = ma.masked_attention_fused.launches
    got = ma.masked_attention_fused(t, torch.from_numpy(mask), 2)
    torch.testing.assert_close(got, ma.masked_attention_plain(t, torch.from_numpy(mask), 2), rtol=0, atol=0)
    assert ma.masked_attention_fused.launches == before


@pytest.mark.parametrize("shape,heads,mask_shape,match", [
    ((2, 5, 3 * 2 * 136), 2, (2, 5), "head width 136"),
    ((2, 5, 3 * 2 * 12), 2, (2, 5), "head width 12"),
    ((2, 5, 3 * 2 * 16 + 1), 2, (2, 5), "not 3·H·hd"),
    ((2, 5, 3 * 2 * 16), 2, (2, 6), "mask"),
    ((2, 5), 2, (2, 5), r"\[B, F, 3·H·hd\]"),
])
def test_check_attention_rejects_what_the_kernel_does_not_take(shape, heads, mask_shape, match):
    with pytest.raises(ValueError, match=match):
        ma.check_attention(torch.zeros(shape), torch.ones(mask_shape), heads)


@pytest.mark.parametrize("hd", [8, 16, 40, 128])
def test_check_attention_takes_every_head_width_the_kernel_pads(hd):
    """The bf16 kernel pads hd to 16, 32, 64 or 128 in shared memory, so the
    wrapper still takes every multiple of 8 in [8, 128]."""
    qkv = torch.zeros(2, 5, 3 * 3 * hd, dtype=torch.bfloat16)
    assert ma.check_attention(qkv, torch.ones(2, 5), 3) == (2, 5, 3, hd)


def test_max_head_dim_is_the_kernels():
    src = (Path(ma.__file__).parents[1] / "csrc" / "masked_attention.cu").read_text()
    assert int(re.search(r"constexpr int kAttnMaxHd = (\d+);", src).group(1)) == ma.MAX_HEAD_DIM


def test_check_attention_limits_and_layout():
    assert ma.check_attention(torch.zeros(3, 4, 3 * 8 * 128, dtype=torch.bfloat16), torch.ones(3, 4), 8) \
        == (3, 4, 8, 128)
    with pytest.raises(ValueError, match="bf16/f32"):
        ma.check_attention(torch.zeros(2, 5, 48, dtype=torch.float16), torch.ones(2, 5), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ma.check_attention(torch.zeros(5, 2, 48).transpose(0, 1), torch.ones(2, 5), 2)
    with pytest.raises(ValueError, match="B <= 65535"):
        ma.check_attention(torch.zeros(65536, 1, 24), torch.ones(65536, 1), 1)
    with pytest.raises(ValueError, match="unsupported device"):
        ma.masked_attention_fused(torch.zeros(2, 5, 48, device="meta"), torch.ones(2, 5), 2)
