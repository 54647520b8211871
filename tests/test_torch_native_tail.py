"""The native runner's MoE combine and top-k on the CPU: ``moe_combine_plain``
against the JAX tail's combine (``ops/fast_infer.py#gated_moe_tail``), and
a NumPy model of ``topk``'s block select (``csrc/native_runner.cu``
``topk_select_kernel``: its threshold and its candidates) against
``top_k_exact`` on rows of heavy ties.  The kernels themselves run on the
card only; chip_smoke.py holds them against these plain versions there."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_torch.ops import native_tail
from learnablepoolingmethods_torch.ops.topk import top_k_exact

from tests.test_torch_ops import SPECIAL_BITS


@pytest.mark.parametrize("v", [3862, 7])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_moe_combine_plain_matches_the_jax_tail(m, v):
    """Σ_{m<M} softmax over the M+1 gates · σ(experts + experts_bias), as
    gated_moe_tail computes it from its products.  f32 on both sides; exp
    and the sigmoid differ by a few ulp between XLA's CPU kernels and
    PyTorch's, so within 1e-6 absolute and 1e-5 relative."""
    rng = np.random.default_rng(10 * m + v)
    b = 5
    ga = rng.normal(scale=3.0, size=(b, (m + 1) * v)).astype(np.float32)
    ea = rng.normal(scale=3.0, size=(b, m * v)).astype(np.float32)
    eb = rng.normal(scale=0.5, size=(m * v,)).astype(np.float32)
    jga = jnp.asarray(ga).reshape(b, m + 1, v)
    jea = (jnp.asarray(ea) + jnp.asarray(eb)).reshape(b, m, v)
    want = np.asarray(jnp.sum(jax.nn.softmax(jga, axis=1)[:, :m] * jax.nn.sigmoid(jea), axis=1))
    got = native_tail.moe_combine_plain(*(torch.from_numpy(a) for a in (ga, ea, eb)), m).numpy()
    assert got.shape == (b, v)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---- a model of topk_select_kernel --------------------------------------------

def test_topk_constants_match_the_kernel():
    """The model below reads the block select's shape from native_tail,
    which mirrors the kernel's constants."""
    src = (Path(native_tail.__file__).resolve().parent.parent / "csrc" / "native_runner.cu").read_text()

    def const(name: str) -> int:
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTopkThreads") == native_tail.TOPK_THREADS
    assert const("kTopkFastK") == native_tail.TOPK_FAST_K
    assert (const("kTopkPerSmall"), const("kTopkPerLarge")) == native_tail.TOPK_PER_THREAD


def select_keys(row: np.ndarray, per: int) -> np.ndarray:
    """The kernel's keys of a row, [per, threads] (entry t + threads·j at
    [j, t]): the score's total-order bits above, 2³² − 1 − index below;
    an index past the row keeps the bits 0."""
    threads = native_tail.TOPK_THREADS
    u = np.zeros(threads * per, dtype=np.uint64)
    u[:row.size] = row.view(np.uint32)
    order = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    order[row.size:] = 0
    index = np.arange(threads * per, dtype=np.uint64)
    return ((order << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - index)).reshape(per, threads)


def block_select(row: np.ndarray, k: int):
    """topk_select_kernel's steps on one row → (values, indices, the count
    of candidates): each lane's largest key; each warp's 32 sorted; θ the
    key of rank k − 1 (its place in its warp's list plus, in every other
    list, the count above it by the kernel's binary search); the entries
    ≥ θ, ranked by the count of candidates above each."""
    threads = native_tail.TOPK_THREADS
    per = next(p for p in native_tail.TOPK_PER_THREAD if row.size <= threads * p)
    keys = select_keys(row, per)
    mine = keys.max(axis=0)
    lists = np.sort(mine.reshape(threads // 32, 32), axis=1)[:, ::-1]
    m = lists.reshape(-1)                       # a lane's key after its warp's sort
    warp = np.arange(threads) // 32
    rank = np.arange(threads) % 32
    for w, lst in enumerate(lists):
        p = np.zeros(threads, dtype=np.int64)
        for s in (16, 8, 4, 2, 1):
            p += np.where(lst[p + s - 1] > m, s, 0)
        p += lst[p] > m
        rank += np.where(warp != w, p, 0)
    assert np.count_nonzero(rank == k - 1) == 1
    theta = m[rank == k - 1][0]
    assert np.count_nonzero(mine >= theta) == k  # the lanes that gather
    cand = keys[:, mine >= theta].reshape(-1)
    cand = cand[cand >= theta]
    assert k <= cand.size <= k * per
    above = (cand[None, :] > cand[:, None]).sum(axis=1)
    picked = np.zeros(k, dtype=np.uint64)
    for key, r in zip(cand, above):
        if r < k:
            picked[r] = key
    assert np.count_nonzero(above < k) == k
    order = picked >> np.uint64(32)
    bits = np.where(order & 0x80000000, order & 0x7FFFFFFF, ~order & 0xFFFFFFFF).astype(np.uint32)
    return bits.view(np.float32), (np.uint64(0xFFFFFFFF) - (picked & np.uint64(0xFFFFFFFF))).astype(np.int64), cand.size


def tie_rows(kind: str, v: int, rng) -> np.ndarray:
    """Four f32 rows of ``kind``, each full of equal scores."""
    if kind == "levels":          # four values: every top-k is made of ties
        rows = rng.integers(0, 4, size=(4, v)).astype(np.float32)
    elif kind == "all_equal":
        rows = np.full((4, v), 0.5, dtype=np.float32)
    elif kind == "signed_zeros":  # ±0 at the boundary, a few above it
        rows = np.where(rng.random((4, v)) < 0.5, np.float32(0.0), np.float32(-0.0)).astype(np.float32)
        rows[:, rng.choice(v, size=min(v, 5), replace=False)] = 1.0
    elif kind == "specials":      # random bits, a tenth ±0, ±inf, ±NaN
        bits = rng.integers(0, 2 ** 32, size=(4, v), dtype=np.uint64).astype(np.uint32)
        at = rng.random((4, v)) < 0.1
        bits[at] = rng.choice(SPECIAL_BITS, size=int(at.sum()))
        rows = bits.view(np.float32)
    elif kind == "ascending":     # sorted levels, the largest last
        rows = np.sort(rng.integers(0, 8, size=(4, v)), axis=1).astype(np.float32)
    elif kind == "stacked":       # the largest in the first lanes' every entry
        rows = rng.integers(0, 3, size=(4, v)).astype(np.float32)
        lanes = np.arange(v) % native_tail.TOPK_THREADS
        rows[:, lanes < 40] += 10.0
    else:
        raise ValueError(kind)
    return rows


@pytest.mark.parametrize("v,k", [(7, 1), (7, 7), (3862, 1), (3862, 20), (3862, 64), (10007, 20),
                                 (10007, 64)])
@pytest.mark.parametrize("kind", ["levels", "all_equal", "signed_zeros", "specials", "ascending", "stacked"])
def test_block_select_model_matches_top_k_exact(kind, v, k):
    """The kernel's rule (a threshold on the lane maxima's (score, index)
    keys, then a rank among the candidates) equals top_k_exact, values as
    bits and indices exactly, on rows of ties: the index in the key leaves
    no tie at θ to gather, and the candidates stay within k · the entries
    a thread holds."""
    assert k <= native_tail.TOPK_FAST_K
    rng = np.random.default_rng(v + k)
    for row in tie_rows(kind, v, rng):
        values, indices, _ = block_select(row, k)
        want_v, want_i = top_k_exact(torch.from_numpy(row.copy()), k)
        np.testing.assert_array_equal(values.view(np.uint32), want_v.numpy().view(np.uint32))
        np.testing.assert_array_equal(indices, want_i.numpy())


def test_block_select_candidates_reach_their_bound():
    """The most candidates a row can give: k − 1 lanes whose every entry
    is above the k-th lane's largest, which is θ, the only candidate of its
    lane: (k − 1) · 16 + 1, within the k · 16 that the kernel's shared
    memory holds."""
    v, k = 4096, 20
    row = np.zeros(v, dtype=np.float32)
    lane = np.arange(v) % native_tail.TOPK_THREADS
    row[lane < k - 1] = 20.0
    row[k - 1] = 10.0
    values, indices, n = block_select(row, k)
    assert n == (k - 1) * 16 + 1
    want_v, want_i = top_k_exact(torch.from_numpy(row), k)
    np.testing.assert_array_equal(values, want_v.numpy())
    np.testing.assert_array_equal(indices, want_i.numpy())
