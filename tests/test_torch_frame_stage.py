"""The native runner's ``frame_stage`` and ``nextvlad_residual`` on the CPU
against the JAX package: their plain versions (``ops/native_tail.py``)
against JAX's arithmetic, and NumPy models of the kernels' partitions and
summation orders (``csrc/native_runner.cu`` ``frame_stage_kernel``,
``nextvlad_residual_kernel``) against JAX's results.  The kernels run on
the card only; chip_smoke.py holds them against these plain versions there.

- ``frame_stage_all_plain`` against ``core/step.py#preprocess_input`` (f32)
  and ``ops/fast_transformer.py``'s staging (bf16), the key mask against
  ``f < num_frames``;
- ``frame_stage_plain`` with the folded input BN against
  ``ops/fast_lf.py``'s staging on JAX's draws (``sample_frame_features``);
- ``nextvlad_residual_plain`` against ``ops/fast_lf.py``'s
  ``agg − a_sum · c2``;
- the residual kernel's tiles and fixed summation order, and the stage
  kernel's word and byte partitions of a row with their Σx² order, each
  covering every column once, against the same JAX results.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.core.step import preprocess_input
from learnablepoolingmethods_tpu.models.model_utils import sample_frame_features
from learnablepoolingmethods_tpu.ops.normalize import l2_normalize as jax_l2_normalize
from learnablepoolingmethods_tpu.utils.quantization import dequantize as jax_dequantize
from learnablepoolingmethods_torch.ops import native_tail as nt
from learnablepoolingmethods_torch.utils import prng

F32 = np.float32
# chip_smoke.py's gate of frame_stage's bf16 output (ROUTE_KERNEL_GATES):
# one bf16 step of the value, 2⁻⁸ of the row's largest beside it
BF16_GATE = (2 ** -8, 2 ** -7)


def _frames(seed: int, b: int, f: int, dt: int, nf) -> tuple:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, f, dt), dtype=np.uint8)
    x[0, 0] = 0  # a row of one repeated value (a padding frame's)
    return x, np.asarray(nf, np.int32)


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _within_bf16_step(got: np.ndarray, want: np.ndarray) -> None:
    """Each entry within one bf16 step of ``want`` (an f32 sum in another
    order, or XLA's excess precision, can move a rounding): |Δ| ≤
    a·max|want| + r·|want| with (a, r) = BF16_GATE."""
    a, r = BF16_GATE
    assert np.all(np.abs(got - want) <= a * np.abs(want).max() + r * np.abs(want))


# ---- the plain versions against the JAX package --------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 4, 1152)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frame_stage_all_plain_matches_jax_staging(dtype, shape):
    """Every frame: f32, core/step.py#preprocess_input (dequantize in f32,
    ℓ2); bf16, ops/fast_transformer.py:282-286 (dequantize in bf16, ℓ2 in
    f32, rounded to bf16); the mask f < num_frames (fast_transformer.py:287-289).
    f32 within 1e-6 (the ℓ2's sum order); bf16 within one step."""
    b, f, dt = shape
    x, nf = _frames(1, b, f, dt, [f, 0, f + 3][:b])
    tdtype = getattr(torch, dtype)
    got, mask = nt.frame_stage_all_plain(torch.from_numpy(x), torch.from_numpy(nf), tdtype)
    if dtype == "float32":
        want = np.asarray(preprocess_input(jnp.asarray(x), jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        want = np.asarray(jax_l2_normalize(jax_dequantize(jnp.asarray(x), dtype=jnp.bfloat16), axis=-1)
                          .astype(jnp.float32))
        _within_bf16_step(got.float().numpy(), want)
    want_mask = np.asarray((jnp.arange(f)[None, :] < jnp.asarray(nf).reshape(-1, 1)).astype(jnp.float32))
    np.testing.assert_array_equal(mask.numpy(), want_mask)


@pytest.mark.parametrize("s,nf", [(4, (7, 1, 3, 0, 12)), (9, (2, 7, 7, 5, 9))])
def test_frame_stage_plain_affine_matches_fast_lf(s, nf):
    """ops/fast_lf.py:305-319: JAX's draws from key(0)
    (sample_frame_features), the bf16 dequantize, ℓ2, the folded input BN
    in f32 and one rounding; the port's plain version draws from
    prng.key(0).  Within one bf16 step (BF16_GATE)."""
    b, f, dt = len(nf), 7, 24
    x, nf = _frames(2, b, f, dt, nf)
    rng = np.random.default_rng(3)
    in_scale = (rng.normal(scale=0.1, size=dt) + 1).astype(F32)
    in_bias = rng.normal(scale=0.05, size=dt).astype(F32)
    got = nt.frame_stage_plain(torch.from_numpy(x), prng.key(0), torch.from_numpy(nf), s,
                               torch.from_numpy(in_scale), torch.from_numpy(in_bias))
    drawn = sample_frame_features(jnp.asarray(x), jnp.asarray(nf), s, jax.random.key(0))
    xs = jax_l2_normalize(jax_dequantize(drawn, dtype=jnp.bfloat16), axis=-1)
    want = np.asarray((xs.astype(jnp.float32) * in_scale + in_bias).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.shape == (b, s, dt) and got.dtype == torch.bfloat16
    _within_bf16_step(got.float().numpy(), want)


def _jax_residual(agg: np.ndarray, assign: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """ops/fast_lf.py:264-265 in jnp: agg − Σ_{S,G} assign · c2."""
    a_sum = jnp.sum(jnp.asarray(assign), axis=(1, 2))
    return np.asarray(jnp.asarray(agg) - a_sum[:, :, None] * jnp.asarray(c2)[None])


def _residual_inputs(b: int, sg: int, k: int, dp: int, seed: int = 4) -> tuple:
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=3.0, size=(b, sg, 1, k))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    assign = (e / e.sum(-1, keepdims=True)).astype(F32)
    return (rng.normal(size=(b, k, dp)).astype(F32), assign,
            rng.normal(scale=0.1, size=(k, dp)).astype(F32))


# NeXtVLAD-128's rgb and audio modules (S·G = 30·8, K = 128, D′ = λD/G) and
# an odd shape (a partial tile of clusters, D′ off the float4 grid)
RESIDUAL_SHAPES = {"rgb": (2, 240, 128, 256), "audio": (2, 240, 128, 32), "odd": (3, 7, 37, 33)}


@pytest.mark.parametrize("label", list(RESIDUAL_SHAPES))
def test_nextvlad_residual_plain_matches_fast_lf(label):
    agg, assign, c2 = _residual_inputs(*RESIDUAL_SHAPES[label])
    got = nt.nextvlad_residual_plain(*(torch.from_numpy(a) for a in (agg, assign, c2)))
    np.testing.assert_allclose(got.numpy(), _jax_residual(agg, assign, c2), rtol=1e-5, atol=1e-5)


# ---- models of the kernels ------------------------------------------------------

def _const(name: str) -> str:
    src = (Path(nt.__file__).resolve().parent.parent / "csrc" / "native_runner.cu").read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


def test_stage_and_residual_constants_match_the_kernel():
    """The models below read the kernels' shapes from native_tail, which
    mirrors their constants."""
    assert int(_const("kStageThreads")) == nt.STAGE_THREADS
    assert int(_const("kStageWords")) == nt.STAGE_WORDS
    assert _const("kStageDT") == "32 * 4 * kStageWords" and nt.STAGE_DT == 32 * 4 * nt.STAGE_WORDS == 1152
    assert int(_const("kResidualThreads")) == nt.RESIDUAL_THREADS
    assert int(_const("kResidualTile")) == nt.RESIDUAL_TILE


def residual_model(agg: np.ndarray, assign: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """nextvlad_residual_kernel's arithmetic: tiles of RESIDUAL_TILE
    clusters, lane l column k0 + l; warp w sums rows w, w + W, … in order
    (W the block's warps), the W partial sums added in warp order; then
    agg − Σ · c2, the product and the difference each rounded in f32.
    Asserts the tiles cover every cluster once."""
    b, k, dp = agg.shape
    a = assign.reshape(b, -1, k)
    sg = a.shape[1]
    warps = nt.RESIDUAL_THREADS // 32
    tiles = [(k0, min(nt.RESIDUAL_TILE, k - k0)) for k0 in range(0, k, nt.RESIDUAL_TILE)]
    columns = [k0 + lane for k0, n in tiles for lane in range(n)]
    assert sorted(columns) == list(range(k)) and len(columns) == k
    asum = np.zeros((b, k), F32)
    for k0, n in tiles:
        cols = slice(k0, k0 + n)
        total = np.zeros((b, n), F32)
        for w in range(warps):
            s = np.zeros((b, n), F32)
            for r in range(w, sg, warps):
                s = (s + a[:, r, cols]).astype(F32)
            total = (total + s).astype(F32)
        asum[:, cols] = total
    return (agg - (asum[:, :, None] * c2[None]).astype(F32)).astype(F32)


@pytest.mark.parametrize("label", list(RESIDUAL_SHAPES))
def test_residual_model_matches_jax(label):
    """The kernel's fixed order against JAX's a_sum (fast_lf.py:264), within
    the f32 tolerance of chip_smoke's gate (1e-5 + 1e-5·|ref|)."""
    agg, assign, c2 = _residual_inputs(*RESIDUAL_SHAPES[label], seed=5)
    np.testing.assert_allclose(residual_model(agg, assign, c2), _jax_residual(agg, assign, c2),
                               rtol=1e-5, atol=1e-5)


def stage_lanes(dt: int) -> list:
    """frame_stage_kernel's columns of a row for each of the 32 lanes, in
    the order a lane sums their squares: the word path (a row of
    STAGE_DT bytes) lane l the words l + 32·j, four columns each; the byte
    path (any other width) lane l the columns l + 32·j."""
    if dt == nt.STAGE_DT:
        return [[4 * (lane + 32 * j) + e for j in range(nt.STAGE_WORDS) for e in range(4)] for lane in range(32)]
    return [list(range(lane, dt, 32)) for lane in range(32)]


def stage_model(x: np.ndarray, dtype: str) -> np.ndarray:
    """frame_stage's all-frames arithmetic on rows x [R, DT]: the dequantize
    (f32: v·qs + qb; bf16: each step rounded), each lane's Σx² over its
    columns in order, the warp's butterfly (lane + lane ^ off, off = 16 …
    1), x · (Σ)^-½ (the card's rsqrtf in f32 here), one rounding to
    ``dtype``.  Asserts the lanes cover every column once."""
    dt = x.shape[1]
    lanes = stage_lanes(dt)
    flat = sorted(c for cols in lanes for c in cols)
    assert flat == list(range(dt))
    qs, qb = F32(4.0 / 255.0), F32(4.0 / 512.0 - 2.0)
    v = x.astype(F32)
    if dtype == "float32":
        d = ((v * qs).astype(F32) + qb).astype(F32)
    else:
        d = _bf16(_bf16(v * _bf16(qs)) + _bf16(qb))
    part = np.zeros((x.shape[0], 32), F32)
    for lane, cols in enumerate(lanes):
        for c in cols:
            part[:, lane] = (part[:, lane] + (d[:, c] * d[:, c]).astype(F32)).astype(F32)
    for off in (16, 8, 4, 2, 1):
        part = (part + part[:, np.arange(32) ^ off]).astype(F32)
    inv = (F32(1) / np.sqrt(np.maximum(part[:, :1], F32(1e-12)))).astype(F32)
    y = (d * inv).astype(F32)
    return y if dtype == "float32" else _bf16(y)


@pytest.mark.parametrize("dt", [1152, 1024, 128, 1151, 3, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_partition_covers_every_column_once_and_matches_jax(dtype, dt):
    """The word path at DT=1152 and the byte path at every other width:
    each column in exactly one lane's share, and the model's rows against
    JAX's staging (preprocess_input in f32 within 1e-6; the bf16 staging
    within one bf16 step)."""
    x, _ = _frames(6, 2, 3, dt, [3, 3])
    x = x.reshape(-1, dt)
    got = stage_model(x, dtype)
    if dtype == "float32":
        want = np.asarray(preprocess_input(jnp.asarray(x), jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        want = np.asarray(jax_l2_normalize(jax_dequantize(jnp.asarray(x), dtype=jnp.bfloat16), axis=-1)
                          .astype(jnp.float32))
        _within_bf16_step(got, want)
