"""Wrappers of the flash-attention CUDA kernel (K4): its prefill forms
and its decode form, with the reference's signatures and semantics
(``repro.kernels.flash.ops.flash_attention_tpu`` / ``flash_decode_tpu``).

A CUDA tensor launches ``csrc/flash_attn.cu`` (the prefill forms) or
``csrc/flash_decode.cu`` (the decode form), or raises; a CPU tensor
takes the plain version in ref.py; any other device raises.  Operands may
be strided views (a slice of a KV cache, a head split of a projection):
only the last dim must be contiguous.  The (dtype, Dk, Dv) of a prefill
alone picks its form (``prefill_form``, the mirror of the C++ dispatch):
a bf16 prefill at (64, 64), (128, 128), (192, 128) (MLA's unpadded heads)
or (256, 256) goes to the wgmma form (``csrc/flash_attn_wgmma.cuh``:
warpgroup products on tiles the tensor memory accelerator copies, one
persistent block an SM walking work items of 128 query rows of one head
in ``wgmma_item``'s order, a producer warp and two consumer warpgroups),
an f32 prefill to the SIMT form.
The decode form splits the keys over blocks (``decode_split``); up to
MAX_CLUSTER splits run as one kernel whose blocks merge in a thread-block
cluster (``decode_cluster``): in bf16 at g >= MMA_MIN_GROUP query heads a
kv head the mma kernel, all g <= 16 heads of a kv head as the rows of one
``mma.sync`` tile, else the cluster kernel, a group of query heads a
block (``decode_head_group``); more run as a split kernel writing a
workspace and a merge kernel, behind one launcher (``decode_kernel``
names the kernel a launch takes).  The tensor-core
and decode forms copy 16-byte rows: their operands must also meet
``_checks.row_misalignment``'s rule, or the wrapper raises (there is no
other form to fall back to); the wgmma form encodes a tensor map per
operand on every call, which the same rule satisfies.

Every launch counts under ``flash_attention`` and under its form,
``flash_attention:<form>`` for the forms of ``FORMS``; ``form_launches``
reads the latter, ``shape_launches`` a form's launches by their shape.

On the CPU the prefill is the operator ``repro_torch::flash_attention``:
its plain version on CPU tensors, and on fake tensors (a dry run) its
outputs' shapes alone, with the flops K4 does (``prefill_flops``: the
unmasked (q, k) pairs) for ``torch.utils.flop_counter``, so that a dry run
counts the attention as K4 runs it, without an S x S score matrix.
"""
from __future__ import annotations

import ctypes
import math
import re
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build, _checks
from torch.utils.flop_counter import register_flop_formula

from .ref import attention_ref

KERNEL = "flash_attention"
FORMS = ("prefill_wgmma", "prefill_simt", "decode")
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_PREFILL_ARGTYPES = ((_P,) * 4 + (_I,) * 8 + (_LL,) * 9
                     + (_I, _I, _I, ctypes.c_float, _P, _P))
_DECODE_ARGTYPES = ((_P,) * 5 + (_I,) * 8 + (_LL,) * 8
                    + (ctypes.c_float, _P))

# the decode form's split: about one block per SM over its grid, chunks of
# at least MIN_CHUNK keys (csrc/flash_decode.cu dec::kMaxSplits = SMS), and
# from CLUSTER_PAIRS (b, kv head) pairs on at most MAX_CLUSTER splits, the
# portable cluster size (dec::kMaxCluster): the splits of one pair then
# merge in a thread-block cluster
SMS = 132
MIN_CHUNK = 16
MAX_CLUSTER = 8
CLUSTER_PAIRS = 16
_DECODE_GROUPS = (8, 6, 4)
# the least g (query heads a kv head) whose bf16 decode takes the mma
# kernel up to MAX_CLUSTER splits (dec::kMmaMinGroup)
MMA_MIN_GROUP = 5
# the decode kernels by the C++ dispatch's codes (flash_decode_kernel)
DECODE_KERNELS = ("decode_split", "decode_cluster", "decode_mma")

# a kernel of the library by its name, mangled (ptxas) or demangled (the
# profiler): kernel, then its type and integer template arguments (mangled
# only); the integers are (Dk, Dv) for the prefill forms (the wgmma form
# bf16 alone), (D, head group) for the decode form's cluster and split
# kernels, D for its mma kernel (bf16 alone)
_ENTRY = re.compile(r"(flash_(?:wgmma|prefill|decode_cluster"
                    r"|decode_split|decode_merge|decode_mma)_kernel)"
                    r"(?:I(f|13__nv_bfloat16)?"
                    r"((?:Li\d+E)*))?")
_FORM_OF = {"flash_wgmma_kernel": "prefill_wgmma",
            "flash_prefill_kernel": "prefill_simt",
            "flash_decode_cluster_kernel": "decode_cluster",
            "flash_decode_split_kernel": "decode_split",
            "flash_decode_merge_kernel": "decode_merge",
            "flash_decode_mma_kernel": "decode_mma"}


def _entry(name: str):
    """(kernel, "f32" or "bf16", integer template arguments) of a K4
    kernel's name (the arguments only from a mangled name), or None."""
    m = _ENTRY.search(name)
    if m is None:
        return None
    return (m.group(1), "f32" if m.group(2) == "f" else "bf16",
            [int(i) for i in re.findall(r"Li(\d+)E", m.group(3) or "")])


def kernel_form(name: str) -> Optional[str]:
    """The form of ``_FORM_OF`` whose kernel a (mangled or demangled)
    kernel name is, or None for a kernel that is not K4's."""
    e = _entry(name)
    return _FORM_OF[e[0]] if e else None


def _resource_key(kernel: str, dtype: str, ints) -> str:
    """"bf16_d256", "bf16_d192_128", "f32_d64", "bf16_d64_g4", "bf16":
    the type, the head dims (Dv when it differs from Dk) and the heads a
    block of the cluster and split kernels (the mma kernel's are 16)."""
    if kernel in ("flash_wgmma_kernel", "flash_prefill_kernel"):
        dk, dv = ints
        return f"{dtype}_d{dk}" + (f"_{dv}" if dv != dk else "")
    return dtype + "".join(f"_{p}{i}" for p, i in zip("dg", ints))


def resources(*built: _build.Built) -> dict:
    """Per kernel (the two prefill forms, the decode form's mma,
    cluster, split and merge kernels), then per ``_resource_key`` ("bf16_d256",
    "bf16_d192_128", "bf16_d256_g4", "bf16"): ptxas's registers, stack
    and spill bytes for each kernel of the built ``flash_attn`` and
    ``flash_decode`` libraries, and each prefill kernel's shared bytes per
    block."""
    out = {}
    for b in built:
        smem = {"flash_wgmma_kernel": "flash_wgmma_smem_bytes",
                "flash_prefill_kernel": "flash_simt_smem_bytes"}
        for name, use in _build.ptxas_usage(b.log).items():
            e = _entry(name)
            if e is None:
                continue
            kernel, dtype, ints = e
            entry = dict(use)
            if kernel in smem:
                fn = getattr(b.lib, smem[kernel])
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int] * len(ints)
                entry["smem_bytes"] = fn(*ints)
            out.setdefault(_FORM_OF[kernel], {})[
                _resource_key(kernel, dtype, ints)] = entry
    return out


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _dtype_code(t: torch.Tensor) -> int:
    return _checks.ATTENTION_DTYPES.index(t.dtype)


def decode_split(skv: int, blocks: int):
    """(kc, nsplit): the decode form's split of ``skv`` keys into nsplit
    chunks of kc keys, chunk c holding keys [c*kc, min((c+1)*kc, skv)),
    for ``blocks`` (b, kv head) pairs.  The split kernel's grid is
    (nsplit, blocks): nsplit aims at one block per SM, but no chunk but
    the last has fewer than MIN_CHUNK keys, none is empty, a span
    shorter than 2 * MIN_CHUNK keys stays one chunk, and from
    CLUSTER_PAIRS pairs on nsplit is at most MAX_CLUSTER (at 16 pairs, 8
    x 16 = 128 blocks), so every span there merges in a cluster."""
    if skv < 1 or blocks < 1:
        raise ValueError(f"{KERNEL}: cannot split {skv} keys over {blocks} "
                         f"blocks")
    nsplit = max(1, min(-(-SMS // blocks), skv // MIN_CHUNK))
    if blocks >= CLUSTER_PAIRS:
        nsplit = min(nsplit, MAX_CLUSTER)
    kc = -(-skv // nsplit)
    return kc, -(-skv // kc)


def decode_cluster(nsplit: int) -> bool:
    """Whether nsplit splits run as the cluster kernel, one launch whose
    nsplit blocks merge in a thread-block cluster (up to MAX_CLUSTER),
    rather than as the split kernel, a workspace and the merge kernel
    (more)."""
    return 1 <= nsplit <= MAX_CLUSTER


def decode_kernel(dtype: torch.dtype, g: int, nsplit: int) -> str:
    """The decode kernel a launch of ``dtype`` at g query heads a kv head
    over nsplit splits takes, as ``csrc/flash_decode.cu``'s
    ``dec::decode_kernel`` picks it (exported as ``flash_decode_kernel``):
    past MAX_CLUSTER splits "decode_split" (the split kernel and the merge
    kernel); up to it "decode_mma" for bf16 at g >= MMA_MIN_GROUP, else
    "decode_cluster"."""
    if g < 1 or nsplit < 1:
        raise ValueError(f"{KERNEL}: no decode kernel at g {g} over "
                         f"{nsplit} splits")
    if not decode_cluster(nsplit):
        return "decode_split"
    if dtype == torch.bfloat16 and g >= MMA_MIN_GROUP:
        return "decode_mma"
    return "decode_cluster"


def decode_head_group(g: int) -> int:
    """The cluster and split kernels' query heads a block (their GT; the
    C++ dispatch ``dec::head_group`` mirrors it) for g query heads a kv
    head: g itself up to 4, 6 for 5-6, 8 for 7-8; above 8 the largest of
    8, 6, 4 that divides g, else 8 (ceil(g / 8) groups, the last part
    empty)."""
    if g < 1:
        raise ValueError(f"{KERNEL}: {g} query heads a kv head")
    if g <= 4:
        return g
    if g <= 8:
        return 6 if g <= 6 else 8
    return next((gt for gt in _DECODE_GROUPS if g % gt == 0), 8)


def prefill_form(dtype: torch.dtype, dk: int, dv: int) -> str:
    """The prefill form that CUDA operands of ``dtype`` at q and k's head
    dim ``dk`` and v's ``dv`` launch, as ``csrc/flash_attn.cu``'s
    prefill_form picks it: f32 the SIMT form, bf16 the wgmma form, at
    every pair of ``_checks.ATTENTION_HEAD_DIMS`` ((64, 64), (128, 128),
    MLA's (192, 128), (256, 256)).  Any other pair or type raises."""
    if (dk, dv) not in _checks.ATTENTION_HEAD_DIMS or \
            dtype not in _checks.ATTENTION_DTYPES:
        raise ValueError(f"{KERNEL}: no prefill form for {dtype} at "
                         f"({dk}, {dv})")
    return "prefill_simt" if dtype != torch.bfloat16 else "prefill_wgmma"


# the H100's L2 bytes: the launcher's chunk rule (wgmma_chunk) and
# kv_read_bytes' model
L2_BYTES = 50 * 2 ** 20
_WG_ROWS = 128           # query rows a work item of the wgmma form
_SMEM_MAX = 232448       # the shared bytes a block can have


def wgmma_plan(dk: int, dv: int) -> dict:
    """The wgmma form's tile plan at q and k's head dim ``dk`` and v's
    ``dv`` (a pair of ``_checks.ATTENTION_HEAD_DIMS``), as
    ``csrc/flash_attn_wgmma.cuh`` fixes it: 128 query rows a work item (64
    a consumer warpgroup), 128 keys a tile (64 at D 256), two stages of K
    and V, two Q buffers where they fit beside the ring (else one: D 256
    and (192, 128)), and the block's shared bytes: the Q buffers (128 x
    dk), the K (keys x dk) and V (keys x dv) ring, 8 bytes an mbarrier
    (each Q buffer's full and empty, each stage's K full, V full, K empty
    and V empty) and 1024 of slack that aligns the swizzled tiles."""
    if (dk, dv) not in _checks.ATTENTION_HEAD_DIMS:
        raise ValueError(f"{KERNEL}: the wgmma form takes (Dk, Dv) of "
                         f"{_checks.ATTENTION_HEAD_DIMS}, got ({dk}, {dv})")
    keys, stages = (64 if dk == 256 else 128), 2

    def smem(qbufs):
        return (qbufs * 2 * _WG_ROWS * dk + stages * 2 * keys * (dk + dv)
                + 8 * (2 * qbufs + 4 * stages) + 1024)
    qbufs = 2 if smem(2) <= _SMEM_MAX else 1
    return {"rows": _WG_ROWS, "keys": keys, "stages": stages,
            "q_buffers": qbufs, "smem_bytes": smem(qbufs)}


def wgmma_grid(batch: int, heads: int, sq: int, sms: int = SMS) -> int:
    """The wgmma form's persistent grid: one block an SM, or one a work
    item where there are fewer."""
    return min(batch * heads * -(-sq // _WG_ROWS), sms)


def wgmma_chunk(batch: int, heads: int, kv_heads: int, sq: int, skv: int,
                dk: int, dv: int, sms: int = SMS) -> int:
    """Work items a chunk of the wgmma form's list, as its launcher picks
    it: two passes of the grid where K and V together exceed half the L2
    (a chunk's heads' K and V then stay in the L2 for their q tiles), else
    the whole list in one."""
    grid = wgmma_grid(batch, heads, sq, sms)
    if batch * kv_heads * skv * (dk + dv) * 2 > L2_BYTES // 2:
        return 2 * grid
    return batch * heads * -(-sq // _WG_ROWS)


def wgmma_item(wk: int, bh_count: int, nqt: int, chunk: int):
    """(batch x head, q tile) of work item ``wk``, the mirror of the
    kernel's ``work_item``: the head-major list (head by head, each
    head's q tiles last first) cut into chunks of ``chunk`` items, the
    last chunk taking the remainder, each chunk's items longest q tile
    first, heads in order."""
    nwork = bh_count * nqt
    if chunk >= nwork:                # one chunk
        return wk % bh_count, nqt - 1 - wk // bh_count
    last = max(0, nwork // chunk - 1)
    c = min(wk // chunk, last)
    s = c * chunk
    e = nwork if c == last else s + chunk
    r = wk - s
    for u in range(nqt):              # u: q tiles before the last
        h0 = (s - u + nqt - 1) // nqt
        n = 0 if e - 1 - u < 0 else max(0, (e - 1 - u) // nqt - h0 + 1)
        if r < n:
            return h0 + r, nqt - 1 - u
        r -= n
    raise ValueError(f"{KERNEL}: work item {wk} past the list of {nwork}")


def wgmma_blocks(batch: int, heads: int, sq: int, chunk: int,
                 sms: int = SMS) -> list:
    """Each block's work items in the order it runs them, (batch x head,
    q tile) each: pass i of the grid over ``wgmma_item``'s list gives
    block x item i grid + x (even i) or i grid + grid - 1 - x (odd i, the
    snake)."""
    nqt = -(-sq // _WG_ROWS)
    grid = wgmma_grid(batch, heads, sq, sms)
    nwork = batch * heads * nqt
    return [[wgmma_item(wk, batch * heads, nqt, chunk)
             for i in range(-(-nwork // grid))
             for wk in (i * grid + (grid - 1 - x if i & 1 else x),)
             if wk < nwork]
            for x in range(grid)]


def item_band(qt: int, sq: int, skv: int, causal: bool, window, q_offset:
              int = 0, keys: int = 128):
    """(first key, key tiles) of the wgmma form's q tile ``qt``: the keys
    its rows' bands meet, as the kernel's ``item`` finds them."""
    row0 = qt * _WG_ROWS
    p0, p1 = row0 + q_offset, min(sq, row0 + _WG_ROWS) + q_offset
    lo, hi = 0, (min(skv, p1) if causal else skv)
    if window:
        if p1 - window >= skv:
            hi = skv
        else:
            lo = max(0, p0 - window + 1)
    return lo, -(-(hi - lo) // keys)


def kv_read_bytes(batch: int, heads: int, kv_heads: int, sq: int, skv: int,
                  dk: int, dv: int, causal: bool = True, window=None,
                  q_offset: int = 0, chunk: Optional[int] = None,
                  sms: int = SMS, l2_bytes: int = L2_BYTES):
    """(K and V bytes the wgmma form reads from device memory, their
    once-bytes) for a work list in chunks of ``chunk`` items
    (``wgmma_chunk``'s unless given), under a model of the L2: the blocks
    start their items in the order a run of equal-cost key tiles gives
    (each block's items one after another, an item's cost its key tiles),
    every item reads its key tiles of K and V when it starts, and the L2
    keeps the last ``l2_bytes`` of tiles (least recently used out).  A
    tile found in the L2 costs nothing; one that is not costs its rows'
    bytes (none past skv).  The once-bytes read every key once: B Hkv skv
    (dk + dv) 2."""
    import heapq
    from collections import OrderedDict
    keys = wgmma_plan(dk, dv)["keys"]
    if chunk is None:
        chunk = wgmma_chunk(batch, heads, kv_heads, sq, skv, dk, dv, sms)
    g = heads // kv_heads
    starts = []                      # (start, block, head, first key, tiles)
    clock = [(0, x) for x in range(wgmma_grid(batch, heads, sq, sms))]
    blocks = wgmma_blocks(batch, heads, sq, chunk, sms)
    nxt = [0] * len(blocks)
    heapq.heapify(clock)
    while clock:
        t, x = heapq.heappop(clock)
        if nxt[x] == len(blocks[x]):
            continue
        bh, qt = blocks[x][nxt[x]]
        nxt[x] += 1
        lo, nt = item_band(qt, sq, skv, causal, window, q_offset, keys)
        starts.append((t, x, bh, lo, nt))
        heapq.heappush(clock, (t + nt, x))
    starts.sort()
    cache, held, read = OrderedDict(), 0, 0
    for _, _, bh, lo, nt in starts:
        b, h = divmod(bh, heads)
        hk = h // g
        for j in range(nt):
            key = (b, hk, lo + j * keys)
            rows = min(keys, skv - key[2])
            if key in cache:
                cache.move_to_end(key)
                continue
            nbytes = rows * (dk + dv) * 2
            read += nbytes
            cache[key] = nbytes
            held += nbytes
            while held > l2_bytes:
                held -= cache.popitem(last=False)[1]
    return read, batch * kv_heads * skv * (dk + dv) * 2


def form_launches() -> dict:
    """Launches of each form of ``FORMS`` since the last
    ``registry.reset_launch_counts``."""
    return {f: _build.launch_count(f"{KERNEL}:{f}") for f in FORMS}


def shape_launches(form: str) -> dict:
    """Launches of ``form`` since the last ``registry.reset_launch_counts``
    by their shape, (B, Sq, Skv, H, Hkv, window, causal): a decode launch
    at Sq 1 over the Skv keys it was given, window None, not causal."""
    return _build.shape_counts(f"{KERNEL}:{form}")


def attention_pairs(sq: int, skv: int, causal: bool, window,
                    q_offset: int = 0) -> int:
    """Unmasked (q, k) pairs of one head: row i, at position
    p = i + q_offset, sees keys max(0, p - W + 1) .. min(p, skv - 1); a
    row whose band is empty averages every key, so it counts skv."""
    # numpy, not torch: a flop formula runs under the fake tensor mode
    p = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(p, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, p - window + 1) if window else np.zeros(sq, np.int64)
    n = hi - lo + 1
    return int(np.where(n > 0, n, skv).sum())


def prefill_flops(q_shape, k_shape, v_shape, causal: bool, window,
                  q_offset: int = 0) -> int:
    """K4's prefill flops: q . k and p . v over the unmasked pairs."""
    B, sq, H, D = q_shape
    return (2 * B * H * (D + v_shape[3])
            * attention_pairs(sq, k_shape[1], causal, window, q_offset))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _plain_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: Optional[int],
                   scale: Optional[float], q_offset: int,
                   return_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    out, lse = attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset, return_lse=True)
    return out.to(q.dtype), (lse if return_lse else lse.new_empty(0))


@_plain_prefill.register_fake
def _(q, k, v, causal, window, scale, q_offset, return_lse):
    B, sq, H, _ = q.shape
    return (q.new_empty((B, sq, H, v.shape[3])),
            q.new_empty((B, H, sq) if return_lse else (0,),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, scale, q_offset,
      return_lse, *, out_shape=None, **kwargs) -> int:
    return prefill_flops(q_shape, k_shape, v_shape, causal, window, q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, scale=None,
                    return_lse: bool = False, q_offset: int = 0):
    """q: (B, Sq, H, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv), GQA
    with g = H // Hkv.  Query i, at position p = i + ``q_offset``, sees
    key j when j <= p (``causal``) and j > p - window (``window``); the
    scores are scaled by ``scale``, 1/sqrt(Dk) unless given.  Returns (B,
    Sq, H, Dv) in q's dtype, and with ``return_lse`` also each row's
    log-sum-exp of the scaled, masked scores, f32 (B, H, Sq), which the
    kernel writes beside out.  On the card (Dk, Dv) must be a pair of
    ``_checks.ATTENTION_HEAD_DIMS``; any scale."""
    if window is not None and window < 1:
        raise ValueError(f"{KERNEL}: window {window} must be at least 1")
    if q_offset < 0:
        raise ValueError(f"{KERNEL}: q_offset {q_offset} must be at least 0")
    if _checks.attention(KERNEL, q, k, v) == "cpu":
        out, lse = torch.ops.repro_torch.flash_attention(
            q, k, v, causal, window, scale, q_offset, return_lse)
        return (out, lse) if return_lse else out
    B, Sq, H, Dk = q.shape
    _, Skv, Hkv, Dv = v.shape
    scale = 1.0 / math.sqrt(Dk) if scale is None else scale
    form = prefill_form(q.dtype, Dk, Dv)
    if form != "prefill_simt":
        _checks.rows_aligned(KERNEL, "bf16 prefill", q=q, k=k, v=v)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if Sq == 0:
        return (out, lse) if return_lse else out
    fn = _build.function("flash_attn", "flash_attn_launch",
                         _PREFILL_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(KERNEL, fn, out.data_ptr(), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), _dtype_code(q), B, H, Hkv,
                      Dk, Dv, Sq, Skv, *_strides(q), *_strides(k),
                      *_strides(v), int(causal), window or 0, q_offset, scale,
                      None if lse is None else lse.data_ptr(), stream,
                      form=form, shape=(B, Sq, Skv, H, Hkv, window,
                                        bool(causal)))
    return (out, lse) if return_lse else out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, *, window=None) -> torch.Tensor:
    """One-token decode: q (B, 1, H, D) against every key of the
    (B, S, Hkv, D) caches it is given, no mask.  As in the reference, the
    query sits at position 0, so ``window`` drops no key: a caller passes
    the span of the cache it wants seen.  On the card, over
    ``decode_split``'s chunks, one counted launch of the kernels
    ``decode_kernel`` names: up to MAX_CLUSTER splits the mma kernel (bf16
    at g >= MMA_MIN_GROUP) or the cluster kernel alone, more the split
    kernel and the merge kernel through an f32 workspace of the splits'
    (m, l, acc) allocated here."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{KERNEL}: decode takes q of shape (B, 1, H, D), "
                         f"got {tuple(q.shape)}")
    if _checks.attention(KERNEL, q, k_cache, v_cache,
                         _checks.DECODE_HEAD_DIMS) == "cpu":
        return attention_ref(q, k_cache, v_cache,
                             causal=False).to(q.dtype)
    _checks.rows_aligned(KERNEL, "decode", q=q, k=k_cache, v=v_cache)
    B, _, H, _ = q.shape
    _, Skv, Hkv, _ = k_cache.shape
    return decode_launch(q, k_cache, v_cache,
                         *decode_split(Skv, B * Hkv))


def decode_launch(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, kc: int, nsplit: int
                  ) -> torch.Tensor:
    """``flash_decode``'s launch over nsplit chunks of kc keys, for CUDA
    operands that ``flash_decode`` has checked: the f32 workspace only
    past MAX_CLUSTER splits.  ``flash_decode`` passes ``decode_split``'s
    chunks; a card test passes others to run every cluster size."""
    B, _, H, D = q.shape
    _, Skv, Hkv, _ = k_cache.shape
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    ws = None if nsplit <= MAX_CLUSTER else torch.empty(
        B * H * nsplit * (D + 2), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_decode", "flash_decode_launch",
                         _DECODE_ARGTYPES)
    qsb, _, qsh = _strides(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(KERNEL, fn, out.data_ptr(),
                      None if ws is None else ws.data_ptr(),
                      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      _dtype_code(q), B, H, Hkv, D, Skv, kc, nsplit, qsb, qsh,
                      *_strides(k_cache), *_strides(v_cache),
                      1.0 / math.sqrt(D), stream, form="decode",
                      shape=(B, 1, Skv, H, Hkv, None, False))
    return out
