"""The native runner's tail on the CPU: ``hidden_sum_plain`` against the
JAX routes' sum orders and ``gating_plain`` against the JAX tail's gating
(``ops/fast_infer.py#gated_moe_tail``), with a NumPy model of the index
map of ``hidden_sum_kernel`` and ``gating_kernel`` (``csrc/native_runner.cu``:
which thread and vector writes which entry, and when the scalar path is
taken); ``moe_combine_plain`` against the JAX tail's combine, and a NumPy
model of ``topk``'s block select (``topk_select_kernel``: its threshold and
its candidates) against ``top_k_exact`` on rows of heavy ties.  The
kernels themselves run on the card only; chip_smoke.py holds them against
these plain versions there."""

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


# ---- hidden_sum and gating -------------------------------------------------------

# (parts, group, bias_first) of each route that ends in the gated tail:
# Willow's (rgb + aud) + hidden_b (ops/fast_infer.py:272-276), the LF loop
# h = hidden_b; h = h + contribution over one or two modalities
# (ops/fast_lf.py:321-327), NetFV's two products a modality
# (ops/fast_lf.py:276-278) and the transformer's product + hidden_b
# (ops/fast_transformer.py:303-308; AttentionNetVLAD's alike)
HIDDEN_ROUTES = {"willow": (2, 1, False), "lf_one_modality": (1, 1, True), "lf_two_modalities": (2, 1, True),
                 "netfv": (4, 2, True), "transformer": (1, 1, False)}


def jax_hidden(route: str, parts, bias):
    """h as the JAX package's fast path writes it for ``route``, jitted on
    the CPU."""
    def willow(p, b):
        return p[0] + p[1] + b

    def lf(p, b):
        h = b
        for contrib in p:
            h = h + contrib
        return h

    def netfv(p, b):
        h = b
        for fv1, fv2 in ((p[0], p[1]), (p[2], p[3])):
            h = h + (fv1 + fv2)
        return h

    def transformer(p, b):
        return p[0] + b

    fn = {"willow": willow, "lf_one_modality": lf, "lf_two_modalities": lf, "netfv": netfv,
          "transformer": transformer}[route]
    h = jax.jit(fn)([jnp.asarray(p) for p in parts], jnp.asarray(bias))
    return np.asarray(h), np.asarray(h.astype(jnp.bfloat16).astype(jnp.float32))


def hidden_inputs(n_parts: int, rows: int, width: int, seed: int):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(scale=0.5, size=(rows, width)).astype(np.float32) for _ in range(n_parts)]
    return parts, rng.normal(scale=0.1, size=(width,)).astype(np.float32)


@pytest.mark.parametrize("rows,width", [(5, 96), (3, 1003)])
@pytest.mark.parametrize("route", sorted(HIDDEN_ROUTES))
def test_hidden_sum_plain_matches_the_jax_orders(route, rows, width):
    """hidden_sum_plain's h equals the JAX route's sum bit for bit (the
    same f32 additions in the same order), and its bf16 h equals JAX's
    ``astype(bfloat16)`` bit for bit."""
    n_parts, group, bias_first = HIDDEN_ROUTES[route]
    parts, bias = hidden_inputs(n_parts, rows, width, seed=rows * width + n_parts)
    want_h, want_hb = jax_hidden(route, parts, bias)
    h, hb = native_tail.hidden_sum_plain([torch.from_numpy(p) for p in parts], torch.from_numpy(bias), group,
                                         bias_first)
    assert h.dtype == torch.float32 and hb.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.numpy().view(np.uint32), want_h.view(np.uint32))
    np.testing.assert_array_equal(hb.float().numpy().view(np.uint32), want_hb.view(np.uint32))


def bf16_steps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a − b| in bf16 steps, of bf16 values held exactly in f32 (the bits'
    distance; the signs agree where it is used)."""
    ia = (a.view(np.uint32) >> 16).astype(np.int32)
    ib = (b.view(np.uint32) >> 16).astype(np.int32)
    return np.abs(np.where(ia & 0x8000, 0x8000 - ia, ia) - np.where(ib & 0x8000, 0x8000 - ib, ib))


@pytest.mark.parametrize("rows,width", [(5, 96), (3, 1003)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gating_plain_matches_gated_moe_tail(dtype, rows, width):
    """gating_plain against gated_moe_tail's two gating lines after the
    product (``ops/fast_infer.py:69-74``), jitted on the CPU: within 1e-6
    in f32 (XLA may contract the scale and bias into an FMA, and its
    sigmoid differs from PyTorch's by an ulp), within one bf16 step of the
    output in bf16 (an ulp either side of a rounding boundary)."""
    rng = np.random.default_rng(rows + width)
    prod = rng.normal(scale=2.0, size=(rows, width)).astype(np.float32)
    h = rng.normal(size=(rows, width)).astype(np.float32)
    g_scale = (rng.normal(scale=0.2, size=(width,)) + 1.0).astype(np.float32)
    g_bias = rng.normal(scale=0.1, size=(width,)).astype(np.float32)
    ct = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    @jax.jit
    def tail_gating(prod, h, g_scale, g_bias):
        gates = prod * g_scale + g_bias
        return (h * jax.nn.sigmoid(gates)).astype(ct)

    want = np.asarray(tail_gating(*(jnp.asarray(a) for a in (prod, h, g_scale, g_bias))).astype(jnp.float32))
    got = native_tail.gating_plain(*(torch.from_numpy(a) for a in (prod, h, g_scale, g_bias)),
                                   getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, width)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert bf16_steps(got, want).max() <= 1


# ---- a model of hidden_sum_kernel's and gating_kernel's index map ---------------

def test_hidden_constants_match_the_kernel():
    """The models below read the blocks' shape from native_tail, which
    mirrors the kernels' constants."""
    src = (Path(native_tail.__file__).resolve().parent.parent / "csrc" / "native_runner.cu").read_text()

    def const(name: str) -> int:
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kHiddenThreads") == native_tail.HIDDEN_THREADS
    assert const("kHiddenVecs") == native_tail.HIDDEN_VECS
    assert const("kGatingThreads") == native_tail.GATING_THREADS
    assert const("kGatingVecs") == native_tail.GATING_VECS
    assert const("kMaxParts") == native_tail.MAX_PARTS
    assert "constexpr int kHiddenTile = 4 * kHiddenThreads * kHiddenVecs;" in src
    assert "static_assert(4 * kGatingThreads * kGatingVecs == kHiddenTile" in src
    assert native_tail.HIDDEN_TILE == 4 * native_tail.HIDDEN_THREADS * native_tail.HIDDEN_VECS
    assert native_tail.HIDDEN_TILE == 4 * native_tail.GATING_THREADS * native_tail.GATING_VECS


MAX_GRID_Y = 65535  # a grid's rows at most (hidden_grid)


def hidden_grid(rows: int, width: int, max_y: int = MAX_GRID_Y) -> tuple:
    """The launchers' grid: a block a tile of HIDDEN_TILE columns of a row."""
    return -(-width // native_tail.HIDDEN_TILE), min(rows, max_y)


def vector_path(width: int, f32_offsets, bf16_offsets=()) -> bool:
    """The launchers' choice: float4s where H % 4 = 0 and every f32
    pointer is on 16 bytes (a bf16 output on 8), offsets in bytes from an
    allocation's 256-byte-aligned start."""
    return width % 4 == 0 and all(o % 16 == 0 for o in f32_offsets) and all(o % 8 == 0 for o in bf16_offsets)


# each kernel's threads a block and float4s a thread
KERNEL_SHAPES = {"hidden_sum": (native_tail.HIDDEN_THREADS, native_tail.HIDDEN_VECS),
                 "gating": (native_tail.GATING_THREADS, native_tail.GATING_VECS)}


def hidden_map(rows: int, width: int, kernel: str = "hidden_sum", max_y: int = MAX_GRID_Y):
    """Every (row, column, thread, vector) that ``kernel`` writes: block
    (bx, by) takes the rows by, by + grid_y, …; of its T threads, thread t
    the columns 4q + e of q = bx · HIDDEN_TILE / 4 + j · T + t (j < V,
    e < 4; KERNEL_SHAPES), those below the width.  The vector and the
    scalar path take the same entries."""
    gx, gy = hidden_grid(rows, width, max_y)
    threads, vecs = KERNEL_SHAPES[kernel]
    bx, t, j, e = np.meshgrid(np.arange(gx), np.arange(threads), np.arange(vecs), np.arange(4), indexing="ij")
    col = (4 * (bx * (native_tail.HIDDEN_TILE // 4) + j * threads + t) + e).ravel()
    thread = (bx * threads + t).ravel()
    vec = j.ravel()
    keep = col < width
    col, thread, vec = col[keep], thread[keep], vec[keep]
    row = np.concatenate([np.arange(by, rows, gy) for by in range(gy)])
    n = col.size
    return np.repeat(row, n), np.tile(col, row.size), np.tile(thread, row.size), np.tile(vec, row.size)


@pytest.mark.parametrize("kernel", sorted(KERNEL_SHAPES))
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("rows", [1, 3, 256])
@pytest.mark.parametrize("width", [1, 3, 1003, 1024, 4096])
def test_hidden_map_writes_every_entry_once(width, rows, offset, kernel):
    """Every entry of a [rows, width] output is written exactly once; the
    vector path is taken only where H % 4 = 0 and the inputs start on 16
    bytes (a product at a 4-byte offset, a view one float in, takes the
    scalar path), and there each thread's four columns start on 16 bytes
    of their row."""
    row, col, thread, vec = hidden_map(rows, width, kernel)
    counts = np.zeros((rows, width), dtype=np.int64)
    np.add.at(counts, (row, col), 1)
    assert (counts == 1).all()
    vector = vector_path(width, [offset, 0, 0], [0])
    assert vector == (width % 4 == 0 and offset == 0)
    if vector:
        starts = (row * width + col)[col % 4 == 0]
        assert (starts * 4 % 16 == 0).all()
        # a thread's (row, vector) holds four consecutive columns
        key = (row * 10 ** 6 + thread * 10 + vec)
        _, per = np.unique(key, return_counts=True)
        assert (per == 4).all()


@pytest.mark.parametrize("kernel", sorted(KERNEL_SHAPES))
@pytest.mark.parametrize("rows,max_y", [(5, 2), (7, 3)])
def test_hidden_map_rows_past_the_grid(rows, max_y, kernel):
    """Rows past the grid's (65,535 on the card) come by the stride
    blockIdx.y + k · gridDim.y, each once."""
    row, col, _, _ = hidden_map(rows, 1030, kernel, max_y)
    counts = np.zeros((rows, 1030), dtype=np.int64)
    np.add.at(counts, (row, col), 1)
    assert (counts == 1).all()


@pytest.mark.parametrize("width", [1003, 1024])
@pytest.mark.parametrize("route", sorted(HIDDEN_ROUTES))
def test_hidden_kernel_order_matches_jax(route, width):
    """hidden_sum_kernel's arithmetic on the entries the map gives it:
    acc = bias, each group's products summed left to right, acc + G_g
    (kBiasFirst), else G_0 + G_1 … then + bias, in f32 each step; it
    equals the JAX route's h bit for bit."""
    n_parts, group, bias_first = HIDDEN_ROUTES[route]
    rows = 3
    parts, bias = hidden_inputs(n_parts, rows, width, seed=width + 7 * n_parts)
    row, col, _, _ = hidden_map(rows, width)
    p = [x[row, col] for x in parts]
    b = bias[col]
    acc = b
    for g in range(0, n_parts, group):
        s = p[g]
        for i in range(1, group):
            s = (s + p[g + i]).astype(np.float32)
        acc = (acc + s).astype(np.float32) if (bias_first or g > 0) else s
    if not bias_first:
        acc = (acc + b).astype(np.float32)
    h = np.full((rows, width), np.nan, dtype=np.float32)
    h[row, col] = acc
    want_h, _ = jax_hidden(route, parts, bias)
    np.testing.assert_array_equal(h.view(np.uint32), want_h.view(np.uint32))


def test_ptxas_report_reads_stack_frame_and_spills(monkeypatch):
    """kernel_build.ptxas_report takes each kernel's registers, stack frame
    and spill bytes from nvcc's -Xptxas -v lines (chip_smoke.py prints them
    for the runner's kernels in its build phase)."""
    from learnablepoolingmethods_torch.ops import kernel_build

    text = (
        "ptxas info    : Compiling entry function '_ZN10lpm_native13gating_kernelILb1ELb0ELb1EEEvPKfS2_S2_S2_"
        "P13__nv_bfloat16Pfxi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN10lpm_native13gating_kernelILb1ELb0ELb1EEEvPKfS2_S2_S2_"
        "P13__nv_bfloat16Pfxi\n"
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 38 registers, 416 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN10lpm_native10topk_keysEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN10lpm_native10topk_keysEv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 24 registers, 2048 bytes smem, 352 bytes cmem[0]\n")
    monkeypatch.setitem(kernel_build._ptxas_output, "fake_source", text)
    gating, topk = kernel_build.ptxas_report("fake_source")
    assert (gating["stack_frame"], gating["spill_stores"], gating["spill_loads"], gating["registers"]) == (16, 8, 4, 38)
    assert (topk["stack_frame"], topk["registers"], topk["static_smem"]) == (0, 24, 2048)
    assert "gating_kernel" in gating["kernel"]
