"""Port ops ≡ JAX ops on the CPU: dequantize, l2_normalize, top-k, frame
sampling, and the plain versions of both CUDA kernels (the kernels
themselves run only on the card; chip_smoke.py holds them against these
plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.ops import fused_frontend as jff
from learnablepoolingmethods_tpu.ops import netvlad_pallas as jnv
from learnablepoolingmethods_tpu.ops.normalize import l2_normalize as j_l2
from learnablepoolingmethods_tpu.ops.topk import top_k_exact as j_topk
from learnablepoolingmethods_tpu.utils import quantization as jq
from learnablepoolingmethods_torch.ops import fused_frontend as tff
from learnablepoolingmethods_torch.ops import native_tail
from learnablepoolingmethods_torch.ops import netvlad_fused as tnv
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.ops.topk import top_k_exact
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils import quantization as tq


def _t(a):
    return torch.from_numpy(np.array(a))


def test_dequantize_bit_exact(rng):
    u8 = rng.integers(0, 256, size=(3, 7, 1152), dtype=np.uint8)
    want = np.asarray(jq.dequantize(jnp.asarray(u8)))
    got = tq.dequantize(_t(u8)).numpy()
    # same two f32 operations on the same f32 constants: bit-exact
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq.dequantize_np(u8), want)
    np.testing.assert_array_equal(tq.quantize_np(want), jq.quantize_np(want))


def test_l2_normalize_tf_semantics(rng):
    x = rng.normal(size=(6, 1152)).astype(np.float32)
    x[1] = 0.0            # all-zero row: stays zero
    x[2] *= 1e-9          # Σx² ≈ 1e-15 < ε: scaled by 1/√ε, not normalised
    x[3] *= 1e-5          # Σx² ≈ 1e-7 > ε: normalised
    want = np.asarray(j_l2(jnp.asarray(x), axis=-1))
    got = l2_normalize(_t(x), dim=-1).numpy()
    # f32 sums of 1152 squares in another order: a few ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got[2], x[2] * 1e6, rtol=1e-5)
    # F.normalize clamps the norm instead and would return x/1e-12 here
    assert not np.allclose(torch.nn.functional.normalize(_t(x[2:3]), dim=-1).numpy(), got[2:3])


def test_top_k_matches_lax(rng):
    scores = rng.random((4, 300)).astype(np.float32)  # no ties
    wv, wi = j_topk(jnp.asarray(scores), 20)
    gv, gi = top_k_exact(_t(scores), 20)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_top_k_ties_lowest_index_first(rng):
    """Scores from {0, 1, 2, 3}: every top-20 is made of exact ties, which
    lax.top_k orders by index, lowest first."""
    scores = rng.integers(0, 4, size=(4, 3862)).astype(np.float32)
    wv, wi = j_topk(jnp.asarray(scores), 20)
    gv, gi = top_k_exact(_t(scores), 20)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))



# the floats that jax.lax.top_k orders by their bits (the float total order
# +NaN > +inf > … > +0 > −0 > … > −inf > −NaN, NaNs by payload): ±0, ±inf,
# the quiet ±NaN, ±NaN of the smallest and the largest payload
SPECIAL_BITS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                         0x7F800001, 0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF], dtype=np.uint32)
TOP_K_FUNCTIONS = {
    "top_k_exact": top_k_exact,
    "topk_plain": native_tail.topk_plain,
}


def special_rows(rng, rows: int, v: int) -> np.ndarray:
    """f32 rows of random bit patterns (about 1 in 256 a NaN or an inf of
    random payload), a tenth of each row then overwritten with
    SPECIAL_BITS, so that equal bits repeat at many indices."""
    bits = rng.integers(0, 2 ** 32, size=(rows, v), dtype=np.uint64).astype(np.uint32)
    at = rng.random((rows, v)) < 0.1
    bits[at] = rng.choice(SPECIAL_BITS, size=int(at.sum()))
    return bits.view(np.float32)


def assert_lax_top_k(got, scores, k):
    """(values, indices) equal to jax.lax.top_k's: values as bits, indices
    exactly."""
    wv, wi = jax.lax.top_k(jnp.asarray(scores), k)
    gv, gi = got
    np.testing.assert_array_equal(gv.numpy().view(np.uint32), np.asarray(wv).view(np.uint32))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("fn", sorted(TOP_K_FUNCTIONS))
def test_top_k_orders_signed_zeros_and_nans_as_lax(fn):
    """0.5, −NaN, −0, +0, −inf, +NaN, +0, −0: lax.top_k puts +NaN first,
    then 0.5, both +0 before both −0 (each pair by index), −inf, and −NaN
    last; a sort on the float values ties ±0 and puts every NaN first."""
    row = np.array([[0x3F000000, 0xFFC00000, 0x80000000, 0, 0xFF800000, 0x7FC00000, 0, 0x80000000]],
                   dtype=np.uint32).view(np.float32)
    got = TOP_K_FUNCTIONS[fn](torch.from_numpy(row.copy()), 8)
    np.testing.assert_array_equal(got[1].numpy(), [[5, 0, 3, 6, 2, 7, 4, 1]])
    assert_lax_top_k(got, row, 8)


@pytest.mark.parametrize("k", [1, 8, 20, 64, 3862])
@pytest.mark.parametrize("fn", sorted(TOP_K_FUNCTIONS))
def test_top_k_total_order_matches_lax(fn, k):
    """64 rows of V=3862 random bit patterns with ±0, ±inf and ±NaN mixed
    in: values bit for bit, indices exactly, at every k up to V."""
    scores = special_rows(np.random.default_rng(k), 64, 3862)
    assert_lax_top_k(TOP_K_FUNCTIONS[fn](torch.from_numpy(scores.copy()), k), scores, k)


def _vlad_inputs(rng, b, f, d, k):
    return dict(
        x=rng.normal(scale=0.2, size=(b, f, d)).astype(np.float32),
        c=rng.normal(scale=0.05, size=(d, k)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32),
        bias=rng.normal(scale=0.1, size=(k,)).astype(np.float32),
        c2=rng.normal(scale=0.05, size=(d, k)).astype(np.float32),
    )


def test_netvlad_reference_matches_jax_and_interpret_kernel(rng):
    a = _vlad_inputs(rng, 3, 12, 256, 16)
    args = [a["x"], a["c"], a["scale"], a["bias"], a["c2"]]
    want_ref = np.asarray(jnv.netvlad_reference(*map(jnp.asarray, args)))
    want_kernel = np.asarray(jnv.netvlad_fused(*map(jnp.asarray, args), interpret=True))
    got = tnv.netvlad_reference(*map(_t, args)).numpy()
    # fp32 throughout; only the summation order differs (as in
    # tests/unit/test_fast_infer.py's kernel-vs-reference check)
    np.testing.assert_allclose(got, want_ref, atol=1e-5)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5)


def test_fold_assignment_bn_matches_jax(rng):
    g, bt, mu = (rng.normal(size=8).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    ws, wb = jnv.fold_assignment_bn(*map(jnp.asarray, (g, bt, mu, var)))
    gs, gb = tnv.fold_assignment_bn(*map(_t, (g, bt, mu, var)))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6, atol=1e-7)


def _frontend_args(rng, dt, d_rgb, k_rgb, d_aud, k_aud):
    # the shapes and scales of tests/unit/test_fused_frontend.py
    return [
        rng.uniform(0.8, 1.2, dt).astype(np.float32),
        rng.normal(scale=0.05, size=dt).astype(np.float32),
        rng.normal(scale=0.1, size=(d_rgb, k_rgb)).astype(np.float32),
        rng.uniform(0.5, 1.5, k_rgb).astype(np.float32),
        rng.normal(scale=0.1, size=k_rgb).astype(np.float32),
        rng.normal(scale=0.1, size=(d_rgb, k_rgb)).astype(np.float32),
        rng.normal(scale=0.1, size=(d_aud, k_aud)).astype(np.float32),
        rng.uniform(0.5, 1.5, k_aud).astype(np.float32),
        rng.normal(scale=0.1, size=k_aud).astype(np.float32),
        rng.normal(scale=0.1, size=(d_aud, k_aud)).astype(np.float32),
    ]


def test_frontend_reference_matches_jax_interpret_kernel(rng):
    """The port draws the frames itself from the key, bit for bit JAX's."""
    b, f, d_rgb, d_aud, k_rgb, k_aud = 2, 10, 24, 8, 4, 2
    x = rng.integers(0, 256, size=(b, f, d_rgb + d_aud), dtype=np.uint8)
    nf = np.array([10, 4], np.int32)
    idx = np.asarray(jff.sample_indices(jax.random.key(1), jnp.asarray(nf), f, 6))
    args = _frontend_args(rng, d_rgb + d_aud, d_rgb, k_rgb, d_aud, k_aud)
    w_rgb, w_aud = jff.netvlad_frontend_fused(
        jnp.asarray(x), jnp.asarray(idx), *map(jnp.asarray, args), interpret=True
    )
    g_rgb, g_aud = tff.netvlad_frontend_reference(_t(x), prng.key(1), _t(nf), 6, *map(_t, args))
    # one bf16 rounding of the sampled rows and of the output, with f32
    # sums in another order (tests/unit/test_fused_frontend.py's 2e-2)
    for got, want in ((g_rgb, w_rgb), (g_aud, w_aud)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), atol=2e-2
        )


def test_sample_indices_bounds():
    nf = torch.tensor([1, 5, 10, 500], dtype=torch.int32)
    idx = tff.sample_indices(prng.key(0), nf, 10, 50)
    assert idx.shape == (4, 50) and idx.dtype == torch.int32
    assert torch.all(idx[0] == 0)       # only frame 0 valid
    assert torch.all(idx[1] < 5)
    assert torch.all((idx[2:] >= 0) & (idx[2:] < 10))  # num_frames > F clamps to F
    assert len(torch.unique(idx[2])) > 5  # draws spread over the valid frames


@pytest.mark.parametrize("wrapper", ["netvlad_fused", "netvlad_frontend"])
def test_wrappers_take_plain_path_on_cpu(rng, wrapper):
    if wrapper == "netvlad_fused":
        a = _vlad_inputs(rng, 2, 5, 32, 4)
        args = [_t(a[n]) for n in ("x", "c", "scale", "bias", "c2")]
        fn, ref = tnv.netvlad_fused, tnv.netvlad_reference
    else:
        x = _t(rng.integers(0, 256, size=(2, 10, 32), dtype=np.uint8))
        args = [x, prng.key(0), torch.tensor([10, 4]), 6] + [_t(a) for a in _frontend_args(rng, 32, 24, 4, 8, 2)]
        fn, ref = tff.netvlad_frontend, tff.netvlad_frontend_reference
    before = fn.launches
    got, want = fn(*args), ref(*args)
    for g, w in zip(got if isinstance(got, tuple) else [got], want if isinstance(want, tuple) else [want]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fn.launches == before == 0


@pytest.mark.parametrize("seed", [0, 5])
def test_sample_indices_equal_jax(seed):
    """The same key draws the same frames in both packages."""
    nf = np.array([1, 7, 300, 150, 1000, 42], np.int32)
    want = np.asarray(jff.sample_indices(jax.random.fold_in(jax.random.key(seed), 3), jnp.asarray(nf), 300, 30))
    got = tff.sample_indices(prng.fold_in(prng.key(seed), 3), torch.from_numpy(nf), 300, 30)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_frames_zero_row_out_of_range(rng):
    """An index outside [0, F) gives a zero row, as the front-end kernel and
    the TPU's one-hot matmul do; the rows in range are gathered exactly."""
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    idx = np.array([[0, 4, 5, -1], [7, 2, 2, 1]], np.int32)
    got = tff.gather_frames(_t(x), _t(idx)).numpy()
    onehot = (np.arange(5)[None, None, :] == idx[:, :, None]).astype(np.float32)
    np.testing.assert_array_equal(got, np.einsum("bsf,bfc->bsc", onehot, x))
    np.testing.assert_array_equal(got[0, 2], 0.0)
    np.testing.assert_array_equal(got[1, 0], 0.0)
