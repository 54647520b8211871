"""ops/netvlad_train.py on the CPU: the plain versions of the CUDA forward
and backward kernels, through the autograd Function, against the JAX
package's custom-VJP ``netvlad_aggregate`` (Pallas interpret mode) and its
``netvlad_aggregate_reference``.  The kernels themselves run only on the
card; chip_smoke.py's train_kernels phase holds them against these plain
versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import netvlad_train as jnt
from learnablepoolingmethods_torch.ops import netvlad_train as tnt

B, F, D, K = 3, 10, 16, 8  # the shapes of tests/unit/test_netvlad_train.py


def _inputs(rng, b=B):
    x = rng.normal(scale=0.3, size=(b, F, D)).astype(np.float32)
    logits = rng.normal(scale=0.5, size=(b, F, K)).astype(np.float32)
    c2 = rng.normal(scale=0.1, size=(D, K)).astype(np.float32)
    w = rng.normal(size=(b, D, K)).astype(np.float32)
    return x, logits, c2, w


def _port(x, logits, c2, w, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tl, tc = (torch.from_numpy(a).requires_grad_() for a in (logits, c2))
    out = tnt.netvlad_aggregate(tx, tl, tc)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, (tx.grad, tl.grad, tc.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_value_and_gradients_match_jax_interpret(rng, dtype):
    x, logits, c2, w = _inputs(rng)
    jx = jnp.asarray(x).astype(dtype)

    def loss(a, b, c):
        return jnp.sum(jnt.netvlad_aggregate(a, b, c, True).astype(jnp.float32) * w)

    want = jnt.netvlad_aggregate(jx, jnp.asarray(logits), jnp.asarray(c2), True)
    want_g = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(logits), jnp.asarray(c2))
    got, got_g = _port(x, logits, c2, w, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got_g[0].dtype == got.dtype
    assert got_g[1].dtype == got_g[2].dtype == torch.float32
    if dtype == "float32":
        # f32 throughout, sums in another order (test_netvlad_train.py:26,44)
        value_tol, grad_tol = 1e-5, 2e-5
    else:
        # the same bf16 rounding points (A and dV₁ before their products, the
        # output and dX at the end): one bf16 ulp of the output, 2^-8 ≈ 4e-3 of
        # the largest value, where an f32 sum lands on the other side of a
        # rounding boundary
        value_tol, grad_tol = 4e-3 * np.abs(np.asarray(want, np.float32)).max(), None
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=value_tol)
    for name, g, wg in zip(("dx", "dlogits", "dc2"), got_g, want_g):
        wg = np.asarray(wg, np.float32)
        atol = grad_tol if grad_tol is not None else 4e-3 * np.abs(wg).max()
        np.testing.assert_allclose(g.float().numpy(), wg, atol=atol, err_msg=name)


def test_function_gradients_match_the_reference_composition(rng):
    """f32: the hand-written backward equals autograd through the plain
    composition (the JAX package's netvlad_aggregate_reference)."""
    x, logits, c2, w = _inputs(rng)
    got, got_g = _port(x, logits, c2, w, torch.float32)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, logits, c2)]
    want = tnt.netvlad_aggregate_reference(*args)
    (want * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for g, a in zip(got_g, args):
        torch.testing.assert_close(g, a.grad, rtol=0, atol=2e-5)


def test_reference_matches_jax_reference(rng):
    x, logits, c2, _ = _inputs(rng)
    want = np.asarray(jnt.netvlad_aggregate_reference(*map(jnp.asarray, (x, logits, c2))))
    got = tnt.netvlad_aggregate_reference(*map(torch.from_numpy, (x, logits, c2))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)  # f32, one einsum in another order


def test_dc2_sums_the_videos_of_the_batch(rng):
    """dC₂ of a batch is the sum of each video's own dC₂ (−dV₁⊙S of that
    video alone), as the TPU kernel accumulates it over its batch grid."""
    x, logits, c2, w = _inputs(rng, b=4)
    args = [torch.from_numpy(a) for a in (x, logits, c2, w)]
    _, _, dc2 = tnt.netvlad_aggregate_backward_plain(*args)
    per_video = sum(
        tnt.netvlad_aggregate_backward_plain(args[0][i:i + 1], args[1][i:i + 1], args[2], args[3][i:i + 1])[2]
        for i in range(4)
    )
    torch.testing.assert_close(dc2, per_video, rtol=0, atol=1e-6)


def test_wrappers_take_the_plain_versions_on_cpu(rng):
    x, logits, c2, w = (torch.from_numpy(a) for a in _inputs(rng))
    before = (tnt.netvlad_aggregate_forward.launches, tnt.netvlad_aggregate_backward.launches)
    torch.testing.assert_close(tnt.netvlad_aggregate_forward(x, logits, c2),
                               tnt.netvlad_aggregate_forward_plain(x, logits, c2), rtol=0, atol=0)
    for g, p in zip(tnt.netvlad_aggregate_backward(x, logits, c2, w),
                    tnt.netvlad_aggregate_backward_plain(x, logits, c2, w)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert (tnt.netvlad_aggregate_forward.launches, tnt.netvlad_aggregate_backward.launches) == before


@pytest.mark.parametrize("bad", ["x_dtype", "logits_shape", "c2_shape", "dv3_dtype", "strided_x"])
def test_kernel_inputs_are_checked(rng, bad):
    x, logits, c2, w = (torch.from_numpy(a) for a in _inputs(rng))
    dv3 = w
    if bad == "x_dtype":
        x = x.double()
    elif bad == "logits_shape":
        logits = logits[:, :5]
    elif bad == "c2_shape":
        c2 = c2[:4]
    elif bad == "dv3_dtype":
        dv3 = w.to(torch.bfloat16)
    else:
        x = torch.cat([x, x], dim=2)[:, :, :D]
    with pytest.raises(ValueError):
        tnt._check("kernel", x, logits, c2, dv3)
