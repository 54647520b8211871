"""The bf16 training kernels' arithmetic and tiling on the CPU.

``csrc/netvlad_train.cu`` runs both training kernels on tensor cores in
bf16: A rounded to bf16 once before Xᵀ·A, dV₁ rounded once before X·dV₁ and
A·dV₁ᵀ, every sum in f32.  Here the plain versions behind the autograd
Function are held against the JAX package's ``netvlad_aggregate`` (Pallas
interpret mode) at shapes off every tile of the new kernels; the backward's
per-cluster identity and its fixed assignment of videos to dC₂ slots are
modelled step by step; and ``train_geometry``, the mirror of the kernels'
tiling, is checked as a pure function.  The kernels themselves run only on
the card: chip_smoke.py holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import netvlad_train as jnt
from learnablepoolingmethods_torch.ops import netvlad_train as tnt

# (B, F, D, K): F below, at and across the 16-sample stages of the V₁ pass
# and the 32 frames of the dA/dX kernel; D and K not multiples of 8 (the
# 2-byte loads); K 260 at D 1024, past a portable cluster (two passes)
SHAPES = [(2, 1, 42, 20), (3, 7, 42, 20), (2, 31, 70, 20), (2, 33, 70, 20), (2, 16, 128, 128),
          (1, 7, 1024, 260)]


def _inputs(rng, b, f, d, k):
    """X, post-BN logits, C₂ and a cotangent at the scales of training (X
    and the logits about unit variance, C₂ at 1/√D, dV₃ at the scale of V₃),
    each value exact in bf16 so both packages see the same numbers."""
    def q(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    return (q(rng.normal(size=(b, f, d))), q(rng.normal(size=(b, f, k))),
            q(rng.normal(scale=d ** -0.5, size=(d, k))), q(rng.normal(scale=(d * k) ** -0.5, size=(b, d, k))))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_F{}_D{}_K{}".format(*s))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_matches_jax_interpret_off_every_tile(rng, dtype, shape):
    x, logits, c2, w = _inputs(rng, *shape)
    jx = jnp.asarray(x).astype(dtype)

    def loss(a, b, c):
        return jnp.sum(jnt.netvlad_aggregate(a, b, c, True).astype(jnp.float32) * w)

    want = np.asarray(jnt.netvlad_aggregate(jx, jnp.asarray(logits), jnp.asarray(c2), True), np.float32)
    want_g = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(logits), jnp.asarray(c2))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tl, tc = (torch.from_numpy(a).requires_grad_() for a in (logits, c2))
    got = tnt.netvlad_aggregate(tx, tl, tc)
    (got.float() * torch.from_numpy(w)).sum().backward()
    assert got.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    assert tl.grad.dtype == tc.grad.dtype == torch.float32
    outs = [(got.detach(), want)] + [(g.grad, np.asarray(wg, np.float32))
                                     for g, wg in zip((tx, tl, tc), want_g)]
    for name, (g, wv) in zip(("out", "dx", "dlogits", "dc2"), outs):
        if dtype == "float32":
            # f32 throughout, sums in another order (test_netvlad_train.py:26,44)
            atol = 1e-5 if name == "out" else 2e-5
        else:
            # the same bf16 rounding points (A and dV₁ before their products,
            # the output and dX at the end): one bf16 step, 2⁻⁸ ≈ 4e-3 of the
            # largest value, where an f32 sum lands on the other side of a
            # rounding boundary (test_torch_train_kernel.py's tolerance)
            atol = 4e-3 * np.abs(wv).max()
        np.testing.assert_allclose(g.float().numpy(), wv, atol=atol, err_msg=name)


def _dv1_as_the_kernel_forms_it(x, logits, c2, dv3):
    """dV₁ as tc_bwd_kernel forms it: per cluster c_k = Σ_D V₁² and p_k =
    Σ_D V₁·dV₃, per video Σ_k c_k·ic_k² and Σ_k ic_k·p_k, then element by
    element with q_k = c·g·(p_k − c·g·Σ(V₃⊙dV₃)·c_k).  A is rounded to X's
    dtype, as in the kernel."""
    a = torch.softmax(logits, dim=-1)
    v1 = torch.einsum("bfd,bfk->bdk", x.float(), a.to(x.dtype).float()) - a.sum(1, keepdim=True) * c2
    c = (v1 * v1).sum(1, keepdim=True)
    p = (v1 * dv3).sum(1, keepdim=True)
    ic = torch.rsqrt(torch.clamp(c, min=tnt.EPS))
    ig = torch.rsqrt(torch.clamp((c * ic * ic).sum(2, keepdim=True), min=tnt.EPS))
    g3 = ig * (ic * p).sum(2, keepdim=True)
    cg = ic * ig
    q = cg * (p - cg * g3 * c)
    v2 = v1 * ic
    dv2 = (dv3 - v2 * ig * g3) * ig
    return (dv2 - v2 * q) * ic


def _dv1_as_the_tpu_kernel_forms_it(x, logits, c2, dv3):
    """dV₁ as _bwd_kernel forms it: the normalisation VJPs over whole
    tensors."""
    _, _, _, inv_c, v2, inv_g = tnt._recompute(x, logits, c2)
    v3 = v2 * inv_g
    dv2 = (dv3 - v3 * torch.sum(v3 * dv3, dim=(1, 2), keepdim=True)) * inv_g
    return (dv2 - v2 * torch.sum(v2 * dv2, dim=1, keepdim=True)) * inv_c


@pytest.mark.parametrize("shape", SHAPES[1:], ids=lambda s: "B{}_F{}_D{}_K{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_dv1_identity_matches_the_normalisation_vjps(rng, shape, dtype):
    """The per-cluster identity that lets the V₁ pass form dV₁ from two
    column sums and two per-video sums gives the TPU kernel's dV₁ in f32,
    with A rounded to X's dtype in both, to the summation order (1e-5 of
    the largest entry)."""
    x, logits, c2, dv3 = (torch.from_numpy(a) for a in _inputs(rng, *shape))
    x = x.to(dtype)
    got = _dv1_as_the_kernel_forms_it(x, logits, c2, dv3)
    want = _dv1_as_the_tpu_kernel_forms_it(x, logits, c2, dv3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("shape", SHAPES[1:], ids=lambda s: "B{}_F{}_D{}_K{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_ds_from_column_sums(rng, shape, dtype):
    """tc_bwd_kernel forms dS_k's Σ_D dV₁·C₂ from two column sums of its
    first sweep, c·(g·(Σ dV₃·C₂ − g·G·c·Σ V₁·C₂) − q_k·c·Σ V₁·C₂) with
    G = Σ(V₃⊙dV₃), so that its second sweep needs no C₂: the TPU kernel's
    −dS_k to the f32 summation order."""
    x, logits, c2, dv3 = (torch.from_numpy(a) for a in _inputs(rng, *shape))
    x = x.to(dtype)
    a = torch.softmax(logits, dim=-1)
    v1 = torch.einsum("bfd,bfk->bdk", x.float(), a.to(x.dtype).float()) - a.sum(1, keepdim=True) * c2
    c, p = (v1 * v1).sum(1, keepdim=True), (v1 * dv3).sum(1, keepdim=True)
    ic = torch.rsqrt(torch.clamp(c, min=tnt.EPS))
    ig = torch.rsqrt(torch.clamp((c * ic * ic).sum(2, keepdim=True), min=tnt.EPS))
    g3 = ig * (ic * p).sum(2, keepdim=True)
    q = ic * ig * (p - ic * ig * g3 * c)
    e, f = (dv3 * c2).sum(1, keepdim=True), (v1 * c2).sum(1, keepdim=True)
    got = ic * (ig * (e - ig * g3 * ic * f) - q * ic * f)
    want = (_dv1_as_the_tpu_kernel_forms_it(x, logits, c2, dv3) * c2).sum(1, keepdim=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("b,groups", [(5, 2), (7, 7), (9, 4)])
def test_dc2_over_fixed_video_groups_is_the_batch_sum(rng, b, groups):
    """The bf16 backward sums −dV₁⊙S of videos y, y + G, ... into slot y,
    each in video order, then the slots in order: the batch's dC₂ to the
    f32 summation order."""
    x, logits, c2, w = (torch.from_numpy(a) for a in _inputs(rng, b, 7, 42, 20))
    per_video = [tnt.netvlad_aggregate_backward_plain(x[i:i + 1], logits[i:i + 1], c2, w[i:i + 1])[2]
                 for i in range(b)]
    slots = [torch.zeros_like(c2) for _ in range(groups)]
    for i, dc2 in enumerate(per_video):
        slots[i % groups] += dc2
    got = sum(slots[1:], slots[0])
    want = tnt.netvlad_aggregate_backward_plain(x, logits, c2, w)[2]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("b,d,k", [(256, 1024, 256), (256, 128, 128), (8, 1024, 500), (8, 1024, 512),
                                   (8, 128, 500), (8, 128, 512), (3, 42, 20), (20, 70, 20),
                                   (20, 8, 10), (4, 2048, 64)])
def test_train_geometry(b, d, k):
    """csrc/netvlad_train.cu#train_geometry, mirrored: the inference
    aggregation's tiling (one pass exactly when a video's blocks fit a
    portable cluster of 8 and D ≤ 1024), the dC₂ slots (video i in slot
    i mod groups, at most 2²² floats of slots) and the dA/dX kernel's
    clusters per warp."""
    geo = tnt.train_geometry(b, d, k)
    assert set(geo) == set(tnt.TRAIN_GEOMETRY_KEYS)
    ds, cs, kc, ktiles, dchunks = (geo[n] for n in ("ds", "cs", "kc", "ktiles", "dchunks"))
    assert 1 <= ds * cs <= 16 and geo["threads"] == 32 * ds * cs
    assert kc * (ktiles - 1) < k <= kc * ktiles and 64 * ds * (dchunks - 1) < d <= 64 * ds * dchunks
    assert geo["one_pass"] == int(dchunks == 1 and ktiles <= 8)
    assert 1 <= geo["groups"] <= b and geo["groups"] * d * k <= max(tnt.DC2_SLOT_FLOATS, d * k)
    assert geo["groups"] == b or (geo["groups"] + 1) * d * k > tnt.DC2_SLOT_FLOATS
    nt = geo["gemm_nt"]
    assert nt in (1, 2, 4, 8) and 64 * nt >= k and (nt == 1 or 32 * nt < k)
    # Willow's modalities take the one-pass cluster kernels (8 blocks a rgb
    # video, 1 an audio video); K 500 and 512 at D 1024 take two passes of
    # 16 blocks; at D 128 a cluster of two
    expect = {(1024, 256): (1, 8), (128, 128): (1, 1), (1024, 500): (0, 16), (1024, 512): (0, 16),
              (128, 500): (1, 2), (128, 512): (1, 2), (2048, 64): (0, 2)}
    if (d, k) in expect:
        assert (geo["one_pass"], ktiles) == expect[(d, k)]
    if (b, d, k) == (256, 1024, 256):
        assert geo["groups"] == 16
    if (b, d, k) == (256, 128, 128):
        assert geo["groups"] == 256
