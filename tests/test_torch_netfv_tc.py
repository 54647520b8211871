"""The arithmetic of the bf16 NetFV kernel on tensor cores, on the CPU.

``csrc/netfv_fused.cu``'s bf16 chain takes the TPU kernel's rounding points:
C in bf16 for the logits, A rounded to bf16 once where it enters fv1 = XᵀA
and fv2 = (X²)ᵀA, X² formed in f32 and rounded to bf16, a_sum summed from
the unrounded A.  ``netfv_reference(kernel_rounding=True)`` takes the same
points; here it is held against the JAX Pallas kernel in interpret mode at
shapes off every tile of the new kernel, the tiling is checked as a pure
function (``netfv_geometry``), and the epilogue's cross-block reduction is
replayed in plain PyTorch.  The kernel itself runs only on the card:
chip_smoke.py holds it against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import netfv_pallas as jfv
from learnablepoolingmethods_torch.ops import netfv_fused as tfv

# S below, at and across the 16-sample ring stages
SAMPLES = (1, 7, 31, 33)
# (B, D, K): D and K not multiples of 8 (the 2-byte load path); D=520 spans
# two blocks' rows (512 + 8) with a partial last slab; the audio module's
# main-path width
SHAPES = ((3, 42, 20), (2, 520, 20), (2, 128, 32))
# bf16 input, bf16 output: both sides compute in f32 from the same bf16
# values and round each output once, so they differ by summation order and
# at most one bf16 step of an output (2⁻⁸ of values below 1), as
# tests/test_torch_lf_kernels.py's BF16_ATOL
BF16_ATOL = 4e-3
EPS = 1e-12


def _inputs(rng, b, s, d, k, dtype):
    """x [b, s, d], C, folded BN, C₂ and σ² at the scales of the module's
    initialisers (C, C₂ and covar_weights normal(1/√D), σ² = covar_weights²
    + 1e-6); x and C exact in ``dtype``, so the two packages see the same
    numbers whatever they cast to."""
    def q(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).float().numpy()

    return [q(rng.normal(scale=0.5, size=(b, s, d))), q(rng.normal(scale=d ** -0.5, size=(d, k))),
            rng.uniform(0.5, 1.5, k).astype(np.float32), rng.normal(scale=0.1, size=k).astype(np.float32),
            rng.normal(scale=d ** -0.5, size=(d, k)).astype(np.float32),
            (np.square(rng.normal(scale=d ** -0.5, size=(d, k))) + 1e-6).astype(np.float32)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_D{}_K{}".format(*s))
@pytest.mark.parametrize("s", SAMPLES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_rounding_matches_jax_interpret_kernel(rng, dtype, s, shape):
    b, d, k = shape
    x, c, sc, bi, c2, cov = _inputs(rng, b, s, d, k, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jfv.netfv_fused(jnp.asarray(x, jdt), *map(jnp.asarray, (c, sc, bi, c2, cov)), interpret=True)
    got = tfv.netfv_reference(torch.from_numpy(x).to(dtype), *map(torch.from_numpy, (c, sc, bi, c2, cov)),
                              kernel_rounding=True)
    # f32: the same function up to the f32 summation order
    # (tests/unit/test_netfv_pallas.py's 1e-5); bf16: BF16_ATOL above
    atol = 1e-5 if dtype == torch.float32 else BF16_ATOL
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (b, d, k)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=atol, rtol=0)


def _raw_fv(x, c, sc, bi, c2, cov):
    """fv1 and fv2 before either normalisation, at the kernels' rounding
    points: f32 [B, D, K] each."""
    a = torch.softmax(torch.einsum("bfd,dk->bfk", x.float(), c.to(x.dtype).float()) * sc + bi, dim=-1)
    a_sum = a.sum(1, keepdim=True)
    ax = a.to(x.dtype).float()
    fv1 = torch.einsum("bfk,bfd->bdk", ax, x.float())
    fv2 = torch.einsum("bfk,bfd->bdk", ax, (x * x).float())
    fv2 = (a_sum * (c2 * c2) + fv2 - 2.0 * fv1 * c2) / (cov * cov) - a_sum
    return (fv1 - a_sum * c2) / cov, fv2


def _normalise_as_the_cluster_does(v, geo):
    """The bf16 kernel's epilogue in plain PyTorch: each block (dtile,
    ktile) sums v² over its 64-row slabs per cluster, the slabs in order;
    every block then forms each cluster's Σ_d over the row tiles in rank
    order, r_k = rsqrt(max(colsq_k, ε)), and the video's total Σ_k
    colsq_k·r_k², and scales v by r_k·rsqrt(max(total, ε))."""
    b, d, k = v.shape
    rows, kc = 64 * geo["ds"], geo["kc"]
    partial = torch.zeros(b, geo["dtiles"], k)
    for dt in range(geo["dtiles"]):
        for slab in range(geo["ds"]):
            lo = dt * rows + 64 * slab
            partial[:, dt] += (v[:, lo:lo + 64] ** 2).sum(1)
    colsq = torch.zeros(b, k)
    for dt in range(geo["dtiles"]):
        colsq += partial[:, dt]
    r = torch.rsqrt(torch.clamp(colsq, min=EPS))
    total = (colsq * r * r).sum(1)
    assert geo["ktiles"] * kc >= k
    return v * r[:, None, :] * torch.rsqrt(torch.clamp(total, min=EPS))[:, None, None]


@pytest.mark.parametrize("b,s,d,k", [(3, 7, 42, 20), (2, 33, 520, 20), (2, 30, 1024, 64), (2, 30, 128, 32),
                                     (2, 31, 128, 512), (2, 1, 1024, 128)])
def test_cross_block_reduction_is_the_reference_normalisation(rng, b, s, d, k):
    """The per-block partial Σ_d fv² summed in rank order, then the
    per-cluster and global scales, equal netfv_reference's two ℓ2
    normalisations of fv1 and of fv2 to the f32 summation order, at shapes
    whose D spans one and two row tiles."""
    geo = tfv.netfv_geometry(d, k)
    assert geo["one_pass"] == 1
    args = [torch.from_numpy(a) for a in _inputs(rng, b, s, d, k, torch.float32)]
    want = tfv.netfv_reference(*args, kernel_rounding=True)
    for raw, w in zip(_raw_fv(*args), want):
        got = _normalise_as_the_cluster_does(raw, geo)
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * w.abs().max().item())


# --fv_cluster_size up to 512 (rgb K, audio K/2), the main path's shapes and
# the small check shapes
GEOMETRY_D = (8, 42, 128, 256, 512, 520, 1024, 2048)
GEOMETRY_K = (10, 16, 20, 32, 64, 128, 256, 512)


@pytest.mark.parametrize("d", GEOMETRY_D)
@pytest.mark.parametrize("k", GEOMETRY_K)
def test_netfv_geometry(d, k):
    """csrc/netfv_fused.cu#fv_geometry, mirrored: warps of 64 rows × 32
    clusters, each holding that tile of fv1 and of fv2 (128 f32
    accumulators a thread), at most 8 a block, covering every row and
    cluster once; one pass exactly when a video's blocks fit a portable
    cluster of 8 (the kernel's shared memory, which the built library
    reports, is checked by chip_smoke.py)."""
    geo = tfv.netfv_geometry(d, k)
    assert tuple(geo) == tfv.GEOMETRY_KEYS[:-1]
    ds, cs, kc, dtiles, ktiles = (geo[n] for n in ("ds", "cs", "kc", "dtiles", "ktiles"))
    assert 1 <= ds * cs <= tfv.MAX_WARPS and geo["threads"] == 32 * ds * cs <= 256 <= 1024
    assert kc == 32 * cs and kc * (ktiles - 1) < k <= kc * ktiles
    assert 64 * ds * (dtiles - 1) < d <= 64 * ds * dtiles
    assert cs <= -(-k // 32)  # no cluster slab is wholly past K
    assert geo["blocks"] == dtiles * ktiles
    assert geo["one_pass"] == int(geo["blocks"] <= tfv.MAX_CLUSTER)
    # registers: the two tiles plus a k16 step's fragments (X, X², bf16(A))
    # inside ptxas's 255 a thread, and a block's threads at 255 registers
    # inside the SM's 65,536
    assert tfv.ACCUMULATORS == 128 and tfv.ACCUMULATORS + 4 + 4 + 8 <= 255
    assert geo["threads"] * 255 <= 65536
    # the split as the .cu head states it: past one cluster at K > 128 for
    # 512 < D ≤ 1024 and at K > 256 for 256 < D ≤ 512, never at D ≤ 256
    if d <= 256:
        assert geo["one_pass"] == 1
    elif d <= 512:
        assert geo["one_pass"] == int(k <= 256)
    elif d <= 1024:
        assert geo["one_pass"] == int(k <= 128)


@pytest.mark.parametrize("d,k,want", [
    ((1024, 64, dict(ds=8, cs=1, dtiles=2, ktiles=2, blocks=4, one_pass=1, threads=256))),
    ((128, 32, dict(ds=2, cs=1, dtiles=1, ktiles=1, blocks=1, one_pass=1, threads=64))),
    ((1024, 128, dict(dtiles=2, ktiles=4, blocks=8, one_pass=1))),
    ((1024, 512, dict(dtiles=2, ktiles=16, blocks=32, one_pass=0))),
    ((1024, 256, dict(blocks=16, one_pass=0))),
    ((128, 512, dict(ds=2, cs=4, kc=128, ktiles=4, blocks=4, one_pass=1))),
    ((520, 20, dict(ds=8, dtiles=2, ktiles=1, blocks=2, one_pass=1))),
    ((42, 20, dict(ds=1, cs=1, blocks=1, one_pass=1, threads=32))),
])
def test_netfv_geometry_at_named_shapes(d, k, want):
    """NetFV-64's two modules take the one-pass kernel (rgb: 2 D-halves × 2
    cluster tiles of 256 threads; audio: one block of 64), as does
    --fv_cluster_size=128's rgb module at a full cluster of 8; K 256 and 512
    at D=1024 take the FMA passes; D=520 puts 8 rows in its second block."""
    geo = tfv.netfv_geometry(d, k)
    assert {n: geo[n] for n in want} == want
