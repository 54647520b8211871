"""FusedAdam (``--fused_adam``): per-leaf clip, Adam and stochastically
rounded bf16 parameters and second moments, at the traffic floor.

Port of ``learnablepoolingmethods_tpu/ops/fused_adam.py`` (``FusedAdam``,
``stochastic_round_bf16``).  For each leaf, with
g32 = f32(g) clipped by its own norm, m32 and v32 are Adam's moments in f32
and p32 = p − lr·(m32·c1)/(√(v32·c2) + ε).  A bf16 leaf stores p and ν
stochastically rounded (the low and the high 16 bits of one random uint32
per element) and m rounded to nearest; an f32 leaf stores all three
exactly.  ``stochastic=False`` rounds every bf16 store to nearest.

The JAX package draws its bits from XLA's ``RngBitGenerator``, a stream
defined by the backend, so the port draws its own: Philox-4x32-10 keyed by
the seed, with the counter (element // 4, leaf index, count), word
element % 4 (:func:`random_bits`).  The CUDA kernel (``csrc/fused_adam.cu``,
two launches a step over every leaf, :func:`fused_adam_kernel`) and the
plain version (:func:`fused_adam_plain`) draw the same bits and sum ‖g‖² in
the same order, so on the card they can be compared entry by entry.
:class:`FusedAdam` is the optimizer the train state drives: a CPU model
takes the plain version, a CUDA model the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from learnablepoolingmethods_torch.config import TrainingConfig
from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.parallel.collectives import column_shard, sum_sharded

# csrc/fused_adam.cu: a block of THREADS threads takes CHUNK elements, each
# thread VEC consecutive elements in each of ROWS rows
THREADS, VEC, ROWS = 256, 8, 4
CHUNK = THREADS * VEC * ROWS
BF16_MAX = float(torch.finfo(torch.bfloat16).max)  # 3.3895e38, bits 0x7F7F0000

_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 3
             + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_void_p])
_SUMSQ_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 4
_UPDATE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_float] * 9
                    + [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_void_p])


def _mulhilo(a: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32 bits of a·c for a 32-bit constant ``a`` and int64
    ``c`` < 2³², with every intermediate below 2⁶³."""
    hi16, lo16 = a >> 16, a & 0xFFFF
    b = c * hi16                      # < 2⁴⁸
    t = c * lo16 + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on int64 tensors holding uint32 values; the same
    rounds as ``csrc/fused_adam.cu#philox``."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK, (k1 + _PHILOX_W[1]) & _MASK
    return c0, c1, c2, c3


def random_bits(numel: int, seed: int, count: int, leaf: int, device=None) -> torch.Tensor:
    """The uint32 (as int64) of each of a leaf's ``numel`` elements: word
    e % 4 of Philox at counter (e // 4, leaf, count) and key ``seed``."""
    q = torch.arange(-(-numel // 4), dtype=torch.int64, device=device)
    full = torch.full_like(q, 0)
    words = philox4x32(q & _MASK, q >> 32, full + (leaf & _MASK), full + (count & _MASK),
                       seed & _MASK, (seed >> 32) & _MASK)
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def stochastic_round_bf16(x32: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Unbiased f32 → bf16 rounding (the JAX package's
    ``stochastic_round_bf16``): add the low 16 bits of ``bits`` (int64 or
    uint32 values) to the bit pattern and truncate; non-finite values and
    |x| ≥ bf16 max take the deterministic cast."""
    x32 = x32.float()
    u = x32.view(torch.int32).to(torch.int64) & _MASK
    u = ((u + (bits.to(torch.int64) & 0xFFFF)) & 0xFFFF0000) >> 16
    dithered = (u - ((u >= 0x8000).to(torch.int64) << 16)).to(torch.int16).view(torch.bfloat16)
    safe = torch.isfinite(x32) & (torch.abs(x32) < BF16_MAX)
    return torch.where(safe, dithered, x32.to(torch.bfloat16))


def _tree_sum(acc: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (THREADS wide) in the kernel's halving order."""
    s = THREADS // 2
    while s >= 1:
        acc = acc[..., :s] + acc[..., s:2 * s]
        s //= 2
    return acc[..., 0]


def leaf_sumsq(g32: torch.Tensor) -> torch.Tensor:
    """‖g32‖² in ``csrc/fused_adam.cu``'s order: each chunk of CHUNK
    elements, thread by thread (row by row, VEC at a time), then the halving
    tree; the chunks' partials, THREADS contiguous runs, then the tree."""
    n = g32.numel()
    nc = max(1, -(-n // CHUNK))
    x = torch.zeros(nc * CHUNK, dtype=torch.float32, device=g32.device)
    x[:n] = g32.reshape(-1)
    sq = (x * x).reshape(nc, ROWS, THREADS, VEC)
    acc = torch.zeros((nc, THREADS), dtype=torch.float32, device=g32.device)
    for r in range(ROWS):
        for j in range(VEC):
            acc = acc + sq[:, r, :, j]
    partials = _tree_sum(acc)
    run = -(-nc // THREADS)
    runs = torch.zeros(THREADS * run, dtype=torch.float32, device=g32.device)
    runs[:nc] = partials
    runs = runs.reshape(THREADS, run)
    acc = torch.zeros(THREADS, dtype=torch.float32, device=g32.device)
    for j in range(run):
        acc = acc + runs[:, j]
    return _tree_sum(acc)


def clip_scale(sumsq: torch.Tensor, clip: float) -> torch.Tensor:
    """min(1, clip / max(√Σg², 1e-20)) in f32, NaN carried through."""
    norm = torch.sqrt(sumsq)
    return torch.minimum(torch.ones_like(norm),
                         torch.tensor(clip, dtype=torch.float32, device=norm.device)
                         / torch.maximum(norm, torch.full_like(norm, 1e-20)))


class AdamConsts:
    """The scalars of one step, in f32 as the JAX package forms them: b1, b2,
    ε and 1 − b1, 1 − b2 (Python floats rounded once), lr(count), and
    c1 = 1/(1 − b1^t), c2 = 1/(1 − b2^t) with t = count + 1."""

    def __init__(self, lr: float, count: int, b1=0.9, b2=0.999, eps=1e-8):
        f = np.float32
        t = f(count + 1)
        self.lr, self.b1, self.b2, self.eps = f(lr), f(b1), f(b2), f(eps)
        self.omb1, self.omb2 = f(1 - b1), f(1 - b2)
        self.c1 = f(1.0) / (f(1.0) - self.b1 ** t)
        self.c2 = f(1.0) / (f(1.0) - self.b2 ** t)

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in vars(self).items()}


def adam_leaf_f32(g32, p, m, v, k: Dict[str, torch.Tensor]):
    """(p32, m32, v32) of one leaf, op by op in the kernel's order."""
    m32 = k["b1"] * m.float() + k["omb1"] * g32
    v32 = k["b2"] * v.float() + (k["omb2"] * g32) * g32
    step = (k["lr"] * (m32 * k["c1"])) / (torch.sqrt(v32 * k["c2"]) + k["eps"])
    return p.float() - step, m32, v32


@torch.no_grad()
def fused_adam_plain(grads, params, ms, nus, consts: AdamConsts, clip: Optional[float],
                     stochastic: bool = True, seed: int = 0, count: int = 0,
                     reduce_sumsq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> None:
    """Plain PyTorch version of :func:`fused_adam_kernel`: one step of
    every leaf, in place, the same arithmetic and bits."""
    sumsq = [leaf_sumsq(g.float()) for g in grads] if clip is not None else None
    if sumsq and reduce_sumsq is not None:
        sumsq = list(reduce_sumsq(torch.stack(sumsq)))
    for i, (g, p, m, v) in enumerate(zip(grads, params, ms, nus)):
        k = consts.tensors(p.device)
        g32 = g.float()
        if clip is not None:
            g32 = g32 * clip_scale(sumsq[i], clip)
        p32, m32, v32 = adam_leaf_f32(g32, p, m, v, k)
        if p.dtype == torch.bfloat16 and stochastic:
            bits = random_bits(p.numel(), seed, count, i, p.device).reshape(p.shape)
            p.copy_(stochastic_round_bf16(p32, bits))
            m.copy_(m32.to(torch.bfloat16))
            v.copy_(stochastic_round_bf16(v32, bits >> 16))
        else:
            p.copy_(p32.to(p.dtype))
            m.copy_(m32.to(m.dtype))
            v.copy_(v32.to(v.dtype))


_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def leaf_table(grads, params, ms, nus) -> Tuple[np.ndarray, int]:
    """The kernel's leaf records (``csrc/fused_adam.cu#Leaf``, eight int64
    each) and the number of chunks over all leaves."""
    rows, chunk0 = [], 0
    for i, (g, p, m, v) in enumerate(zip(grads, params, ms, nus)):
        ptrs = [g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr()]
        aligned = int(all(ptr % 16 == 0 for ptr in ptrs))
        flags = int(p.dtype == torch.bfloat16) | (int(g.dtype == torch.bfloat16) << 32)
        rows.append(ptrs + [p.numel(), chunk0, flags, aligned | (i << 32)])
        chunk0 += -(-p.numel() // CHUNK)
    return np.array(rows, dtype=np.uint64).view(np.int64), chunk0


@torch.no_grad()
def fused_adam_kernel(grads, params, ms, nus, consts: AdamConsts, clip: Optional[float],
                      stochastic: bool = True, seed: int = 0, count: int = 0,
                      reduce_sumsq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> None:
    """One step of every leaf in place on the card: ``csrc/fused_adam.cu``,
    the norm launch (with a clip) and the update launch.  Each leaf's g, p,
    m and ν lie on one CUDA device and are contiguous; p, m, ν share a dtype
    (bf16 or f32), g is bf16 or f32.  With ``reduce_sumsq`` (and a clip)
    the two launches go through their own entry points, and between them
    ``reduce_sumsq`` maps the leaves' Σg² ``[n]`` to the whole leaves'
    (the sums over the ranks of a split leaf)."""
    dev = params[0].device
    for g, p, m, v in zip(grads, params, ms, nus):
        for t in (g, p, m, v):
            if t.device != dev or not t.is_contiguous() or t.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError("fused_adam_kernel: every tensor contiguous f32 or bf16 on one device")
        if not (p.dtype == m.dtype == v.dtype) or g.shape != p.shape:
            raise ValueError("fused_adam_kernel: p, m and ν share a dtype and g has p's shape")
    table_np, n_chunks = leaf_table(grads, params, ms, nus)
    n = len(params)
    table = torch.from_numpy(table_np).pin_memory().to(dev, non_blocking=True)
    counters = _counters.get((dev, n))
    if counters is None:
        counters = _counters[(dev, n)] = torch.zeros(n, dtype=torch.int32, device=dev)
    partials = torch.empty(max(n_chunks, 1), dtype=torch.float32, device=dev)
    scales = torch.empty(n, dtype=torch.float32, device=dev)
    c = consts
    tail = (float(c.lr), float(c.b1), float(c.omb1), float(c.b2), float(c.omb2), float(c.eps), float(c.c1),
            float(c.c2), int(stochastic), seed, count)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if reduce_sumsq is None or clip is None:
            fn = kernel_build.load_function("fused_adam", "lpm_fused_adam", _ARGTYPES)
            rc = fn(table.data_ptr(), n, n_chunks, partials.data_ptr(), counters.data_ptr(),
                    scales.data_ptr(), float(clip or 0.0), *tail, stream)
        else:
            fn = kernel_build.load_function("fused_adam", "lpm_fused_adam_sumsq", _SUMSQ_ARGTYPES)
            kernel_build.check(fn(table.data_ptr(), n, n_chunks, partials.data_ptr(), counters.data_ptr(),
                                  scales.data_ptr(), stream), "fused_adam")
            sumsq = reduce_sumsq(scales).contiguous()
            fn = kernel_build.load_function("fused_adam", "lpm_fused_adam_update", _UPDATE_ARGTYPES)
            rc = fn(table.data_ptr(), n, n_chunks, sumsq.data_ptr(), float(clip), *tail, stream)
    kernel_build.check(rc, "fused_adam")
    fused_adam_kernel.launches += 1


fused_adam_kernel.launches = 0


def fused_adam_update(grads, params, ms, nus, consts: AdamConsts, clip: Optional[float],
                      stochastic: bool = True, seed: int = 0, count: int = 0,
                      reduce_sumsq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> None:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    fn = fused_adam_plain if params[0].device.type == "cpu" else fused_adam_kernel
    fn(grads, params, ms, nus, consts, clip, stochastic, seed, count, reduce_sumsq)


class FusedAdam:
    """The optimizer of ``--fused_adam`` (the JAX package's ``FusedAdam``,
    which its train state calls through ``fused_apply``): ``step(grads)``
    updates every parameter in place.  Its state is JAX's
    ``FusedAdamState``: ``count``, ``m/<param>`` and ``nu/<param>``, in bf16
    for a bf16 parameter and f32 otherwise.  A parameter split over a model
    group (``parallel/collectives.py#ColumnShard``) is clipped by the whole
    tensor's norm: its Σg² is summed over the group between the launches;
    its random bits are keyed by its local elements."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]], cfg: TrainingConfig,
                 stochastic: bool = True, seed: int = 0):
        from learnablepoolingmethods_torch.core.optimizers import learning_rate_schedule

        named_params = [item if isinstance(item, tuple) else (str(i), item)
                        for i, item in enumerate(named_params)]
        self.names = [name.replace(".", "/") for name, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule = learning_rate_schedule(cfg)
        self.clip_norm = cfg.clip_gradient_norm if cfg.clip_gradient_norm > 0 else None
        self.stochastic, self.seed = stochastic, int(seed)
        self.count = 0
        state_dtype = [torch.bfloat16 if p.dtype == torch.bfloat16 else torch.float32 for p in self.params]
        self.m = [torch.zeros_like(p, dtype=dt) for p, dt in zip(self.params, state_dtype)]
        self.nu = [torch.zeros_like(p, dtype=dt) for p, dt in zip(self.params, state_dtype)]
        self.shards = [column_shard(p) for p in self.params]

    def consts(self) -> AdamConsts:
        return AdamConsts(self.schedule(self.count), self.count, self.b1, self.b2, self.eps)

    def state_shards(self):
        """``m/<param>`` and ``nu/<param>`` are split as their parameter."""
        return {f"{slot}/{name}": shard for slot in ("m", "nu")
                for name, shard in zip(self.names, self.shards) if shard is not None}

    def _reduce_sumsq(self, sumsq: torch.Tensor) -> torch.Tensor:
        split = [s is not None for s in self.shards]
        group = next(s.group for s in self.shards if s is not None)
        return torch.stack(sum_sharded(list(sumsq), split, group))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.contiguous() for g in grads]
        reduce = self._reduce_sumsq if any(s is not None for s in self.shards) else None
        fused_adam_update(grads, [p.data for p in self.params], self.m, self.nu, self.consts(),
                          self.clip_norm, self.stochastic, self.seed, self.count, reduce)
        self.count += 1

    def state_tree(self) -> Dict[str, torch.Tensor]:
        tree = {"count": torch.tensor(self.count, dtype=torch.int32)}
        for slot, tensors in (("m", self.m), ("nu", self.nu)):
            tree.update({f"{slot}/{name}": t for name, t in zip(self.names, tensors)})
        return tree

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, torch.Tensor]) -> None:
        self.count = int(tree["count"])
        for slot, tensors in (("m", self.m), ("nu", self.nu)):
            for name, t in zip(self.names, tensors):
                t.copy_(tree[f"{slot}/{name}"])
