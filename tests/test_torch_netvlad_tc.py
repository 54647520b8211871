"""The arithmetic of the bf16 NetVLAD kernels on tensor cores, on the CPU.

``csrc/netvlad_tc.cuh`` (both inference kernels' bf16 chain) splits the
soft assignment into A_hi = bf16(A) and A_lo = bf16(A − A_hi) for the
aggregation's two tensor-core products, and sums a_sum from the unrounded A;
``netvlad_reference(kernel_rounding=True)`` takes those rounding points.
Here it is held against the JAX package's reference and its Pallas kernel
in interpret mode, and the launch geometry that picks one- or two-pass
aggregation is checked as a pure function.  The kernels themselves run only
on the card: chip_smoke.py holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import netvlad_pallas as jnv
from learnablepoolingmethods_torch.ops import netvlad_fused as tnv

# small widths off every tile of the kernels: D and K not multiples of 8
# (the 2-byte load path), S below, at and across the 16-sample stages
B, D, K = 3, 42, 20
SAMPLES = (1, 7, 31, 33)


def _inputs(rng, s, dtype):
    """x [B, s, D], C, folded BN and C₂ at the scales of the model's
    initialisers, every value exact in ``dtype`` (so the two packages see
    the same numbers whatever they cast to)."""
    def q(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).float().numpy()

    return [q(rng.normal(scale=0.5, size=(B, s, D))), q(rng.normal(scale=D ** -0.5, size=(D, K))),
            rng.uniform(0.5, 1.5, K).astype(np.float32), rng.normal(scale=0.1, size=K).astype(np.float32),
            rng.normal(scale=D ** -0.5, size=(D, K)).astype(np.float32)]


@pytest.mark.parametrize("s", SAMPLES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_rounding_matches_jax_reference_and_interpret_kernel(rng, dtype, s):
    x, c, sc, bi, c2 = _inputs(rng, s, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs = [jnp.asarray(x, jdt), jnp.asarray(c), jnp.asarray(sc), jnp.asarray(bi), jnp.asarray(c2)]
    want_ref = np.asarray(jnv.netvlad_reference(*jargs), np.float32)
    want_kernel = np.asarray(jnv.netvlad_fused(*jargs, interpret=True), np.float32)
    got = tnv.netvlad_reference(torch.from_numpy(x).to(dtype), *map(torch.from_numpy, (c, sc, bi, c2)),
                                kernel_rounding=True)
    assert got.dtype == dtype and got.shape == (B, D, K)
    got = got.float().numpy()
    if dtype == torch.float32:
        # A_hi + A_lo is A to 2⁻¹⁸ relative, far inside the f32 tolerance of
        # the summation order (tests/unit/test_netvlad_pallas.py's 1e-5)
        tol = dict(atol=1e-5, rtol=0)
    else:
        # the same f32 values up to that, each output rounded to bf16 once:
        # values on either side of a rounding boundary land one bf16 step
        # apart, at most 2⁻⁷ of the value
        tol = dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(got, want_ref, **tol)
    np.testing.assert_allclose(got, want_kernel, **tol)


def _vlad_a_rounded_once(x, c, sc, bi, c2):
    """The descriptors with A rounded to bf16 once where it enters XᵀA
    (as the training kernels' kRoundA does), a_sum unrounded."""
    a = torch.softmax(torch.einsum("bfd,dk->bfk", x, c) * sc + bi, dim=-1)
    vlad = torch.einsum("bfk,bfd->bdk", a.to(torch.bfloat16).float(), x) - a.sum(1, keepdim=True) * c2
    vlad = vlad / torch.sqrt(torch.clamp((vlad ** 2).sum(1, keepdim=True), min=1e-12))
    return vlad / torch.sqrt(torch.clamp((vlad ** 2).sum((1, 2), keepdim=True), min=1e-12))


@pytest.mark.parametrize("s", SAMPLES)
def test_assignment_split_keeps_f32_accuracy(rng, s):
    """A_hi + A_lo is A to 2⁻¹⁸ relative: the f32 descriptors move by under
    1e-5 of their largest entry (1.6e-6 measured at S=1, where the centring
    cancels most), fifty times less than one bf16 rounding of A moves them."""
    args = [torch.from_numpy(a) for a in _inputs(rng, s, torch.float32)]
    exact = tnv.netvlad_reference(*args)
    split_err = (tnv.netvlad_reference(*args, kernel_rounding=True) - exact).abs().max().item()
    once_err = (_vlad_a_rounded_once(*args) - exact).abs().max().item()
    assert split_err <= 1e-5 * exact.abs().max().item()
    assert 50 * split_err <= once_err


@pytest.mark.parametrize("d", [8, 42, 128, 1024])
@pytest.mark.parametrize("k", [1, 10, 20, 32, 128, 256, 500, 512])
def test_aggregation_geometry(d, k):
    """csrc/netvlad_tc.cuh#tc_geometry, mirrored: warps of 64 rows × 32
    clusters, at most 16 a block, covering every row and cluster once; one
    pass exactly when a video's blocks fit a portable cluster of 8."""
    geo = tnv.aggregation_geometry(d, k)
    assert set(geo) == set(tnv.GEOMETRY_KEYS)
    ds, cs, kc, ktiles, dchunks = (geo[n] for n in ("ds", "cs", "kc", "ktiles", "dchunks"))
    assert 1 <= ds * cs <= 16 and geo["threads"] == 32 * ds * cs <= 512
    assert kc == 32 * cs and kc * (ktiles - 1) < k <= kc * ktiles
    assert 64 * ds * (dchunks - 1) < d <= 64 * ds * dchunks
    assert dchunks == 1  # every D here fits one block's 16 row slabs
    assert cs <= -(-k // 32)  # no cluster slab is wholly past K
    assert geo["one_pass"] == int(ktiles <= 8)
    # the shapes of the main paths take the one-pass cluster kernel; K 500
    # and 512 at D=1024 need 16 blocks a video, past the portable cluster
    if (d, k) in ((1024, 256), (128, 128)):
        assert geo["one_pass"] == 1 and ktiles == {1024: 8, 128: 1}[d]
    if d == 1024 and k in (500, 512):
        assert geo["one_pass"] == 0 and ktiles == 16


def test_aggregation_geometry_splits_d_past_1024():
    """Rows past one block's 1024 take more blocks along D, and so the
    two-pass kernel, whose scratch then holds B·dchunks·K partial sums."""
    geo = tnv.aggregation_geometry(2048, 64)
    assert geo["dchunks"] == 2 and geo["ds"] == 16 and geo["one_pass"] == 0
    assert tnv.aggregation_geometry(1025, 8)["dchunks"] == 2
