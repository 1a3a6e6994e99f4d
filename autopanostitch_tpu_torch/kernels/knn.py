"""B1: exact k-NN (squared L2) — CUDA kernel wrappers and plain versions.

Port of `two_nn_pallas` (`autopanostitch_tpu/ops/pallas/match_kernel.py:129`)
in two modes of one kernel (`csrc/knn.cu`):

- `knn`, pooled: generalised from 2 to k neighbours, the body of the pooled
  matcher `global_knn` (`autopanostitch_tpu/ops/matching.py:253`): k = 4
  with same-image/invalid masks there, k = 2 with `self_idx` reproduces
  `two_nn_pallas`. Mask encoding: `tid == -2` marks an invalid target,
  `qid == -2` an invalid query (its whole row is masked), `self_idx[i]` the
  target index the query must not match.
- `knn_pairs`, pair list: the exact 2-NN of `two_nn` (`matching.py:65`) on
  every image pair of a list, both directions, in one launch — what
  `match_pair` needs for the pairwise rescue and the second passes. Only
  invalid targets are masked, as `two_nn` does.

Masked distances are `BIG` = 1e18 and still compete, so a row with fewer
than k valid targets is filled with the lowest-index masked targets —
exactly what `jax.lax.top_k` returns on the reference's masked distance row.

With `compute_dtype="float32"` the kernel chooses the k winners from q.t
products on the TF32 tensor cores with a 3xTF32 split, which keeps float32
accuracy (~1e-6 in the distance of unit descriptors, exact on small-integer
ones), then recomputes the winners' distances in float32 from direct
differences (an exact duplicate reads 0); the plain version uses float32
matmuls with TF32 off. With `compute_dtype="bfloat16"` both take the
reference's bf16 path (`pairwise_sqdist` with a bf16 cross term): q and t
rounded to bf16, their products summed in float32, the distance
max(|q|^2 + |t|^2 - 2 q.t, 0) from float32 norms, and no refinement. The
bf16 kernel's prologue rounds each set to bf16 once, into the norm scratch
the wrapper allocates (`bf16_scratch_floats`); `prep_bf16_plain` is its
plain version. On
{0,1} vectors (the corner detectors' binary descriptors, 256 wide) every
product is exact either way, so ties keep the plain version's (distance,
index) order bit for bit.

Widths: the kernel takes multiples of 32 up to 256; the wrappers pad other
widths with zero columns (`pad_width`), which adds 0 to every norm and
product in either operand type. k: the plain versions take any k; the
kernel's instances are K = 2, 4, 8, 16 (pooled) and 2 (pair list), and a K
instance serves every k <= K by its first k columns.
"""

from __future__ import annotations

import torch

from autopanostitch_tpu_torch.kernels import _build

BIG = 1e18
COMPUTE_DTYPES = ("float32", "bfloat16")
MAX_K = 16  # largest k of the pooled kernel (its K = 16 instance)
POOLED_K = (2, 4, 8, MAX_K)  # the pooled kernel's instances
launches = 0  # number of CUDA kernel launches through `knn`
pair_launches = 0  # number of CUDA kernel launches through `knn_pairs`
bf16_launches = 0  # of `launches`, those of the bf16 instance
bf16_pair_launches = 0  # of `pair_launches`, those of the bf16 instance
_PLAIN_CHUNK_BYTES = 1 << 30  # bound of the plain pair-list version's working set


def check_compute_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of {COMPUTE_DTYPES}")


def operand(x, compute_dtype: str = "float32"):
    """The cross term's operand: x itself, or x rounded to bf16 (to nearest
    even, as the reference's astype) and held in float32. Products of two
    bf16 values are exact in float32, so a float32 product of the rounded
    operands sums the reference's bf16 products in float32, which XLA's
    `preferred_element_type=float32` does (a bf16 `torch.mm` on the CPU
    would round the sums to bf16)."""
    return x.to(torch.bfloat16).float() if compute_dtype == "bfloat16" else x


def bf16_width(D: int) -> int:
    """Columns of a bf16 copy's rows: D rounded up to whole 128-byte rows
    (64 bf16), as the bf16 instance's TMA boxes read them
    (`csrc/knn_bf16.cuh` bf16_width)."""
    return 64 * -(-D // 64)


def bf16_scratch_floats(F: int, D: int) -> int:
    """float32 elements of the bf16 instance's scratch for F rows of width D
    (`csrc/knn_bf16.cuh` bf16_rows_at): F norms padded to a multiple of 64,
    then F rows of bf16_width(D) bf16."""
    return -(-F // 64) * 64 + F * bf16_width(D) // 2


def prep_bf16_plain(x):
    """Plain version of the bf16 instance's prologue (`row_prep_bf16` in
    `csrc/knn.cu`): (|x|^2 (F,) float32, x rounded to bf16 to nearest even
    and zero-padded to bf16_width(D) columns, (F, W) bfloat16)."""
    norms = torch.sum(x * x, dim=-1)
    rows = torch.nn.functional.pad(x, (0, bf16_width(x.shape[-1]) - x.shape[-1]))
    return norms, rows.to(torch.bfloat16)


def pad_width(x):
    """x (..., D) with zero columns appended up to the next multiple of 32
    (the kernel's widths); x itself when D is one."""
    extra = -x.shape[-1] % 32
    return torch.nn.functional.pad(x, (0, extra)) if extra else x


def knn_plain(desc_q, qid, desc_t, tid, k: int, self_idx=None, block: int = 1024,
              compute_dtype: str = "float32"):
    """Plain PyTorch version: blocked squared distances (the cross term in
    `compute_dtype`, norms in float32), the same masks, and a STABLE sort
    (ties keep the lower target index). Returns (idx (Fq, k) int32, dist
    (Fq, k) float32)."""
    Fq = desc_q.shape[0]
    tn = torch.sum(desc_t * desc_t, dim=-1)
    t_op = operand(desc_t, compute_dtype)
    ar = torch.arange(desc_t.shape[0], device=desc_t.device)
    idx_out, d_out = [], []
    for s in range(0, Fq, block):
        q = desc_q[s : s + block]
        qi = qid[s : s + block]
        qn = torch.sum(q * q, dim=-1)
        cross = operand(q, compute_dtype) @ t_op.T
        d = torch.clamp(qn[:, None] + tn[None, :] - 2.0 * cross, min=0.0)
        bad = (tid[None, :] == qi[:, None]) | (tid[None, :] == -2) | (qi[:, None] == -2)
        if self_idx is not None:
            bad = bad | (ar[None, :] == self_idx[s : s + block, None])
        d = torch.where(bad, torch.full_like(d, BIG), d)
        vals, order = torch.sort(d, dim=1, stable=True)
        idx_out.append(order[:, :k].to(torch.int32))
        d_out.append(vals[:, :k])
    return torch.cat(idx_out), torch.cat(d_out)


def _knn_cuda(desc_q, qid, desc_t, tid, k, self_idx, compute_dtype):
    global launches, bf16_launches
    lib = _build.library()
    same = desc_t is desc_q  # the kernel then computes the norms once
    desc_q = pad_width(desc_q)
    desc_t = desc_q if same else pad_width(desc_t)
    Fq, D = desc_q.shape
    Ft = desc_t.shape[0]
    K = next(K for K in POOLED_K if K >= k)
    dev = desc_q.device
    bf = compute_dtype == "bfloat16"
    # norm scratches; the bf16 instance also keeps each set rounded there
    # (the targets' unused when they are the queries)
    qn = torch.empty(bf16_scratch_floats(Fq, D) if bf else Fq, dtype=torch.float32, device=dev)
    tn = torch.empty(0 if bf and same else bf16_scratch_floats(Ft, D) if bf else Ft,
                     dtype=torch.float32, device=dev)
    idx = torch.empty((Fq, K), dtype=torch.int32, device=dev)
    dist = torch.empty((Fq, K), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.apst_knn(
        desc_q.data_ptr(), qid.data_ptr(),
        None if self_idx is None else self_idx.data_ptr(), Fq,
        desc_t.data_ptr(), tid.data_ptr(), Ft, D, K, int(bf),
        qn.data_ptr(), tn.data_ptr(), idx.data_ptr(), dist.data_ptr(), stream,
    )
    _build.check(err, "apst_knn")
    launches += 1
    bf16_launches += bf
    if K != k:
        idx, dist = idx[:, :k].contiguous(), dist[:, :k].contiguous()
    return idx, dist


MAX_WIDTH = 256  # widest descriptor the kernel takes (csrc/knn.cuh DMAX)


def check_width(D: int, name: str = "knn kernel") -> None:
    """Raise ValueError unless the kernel takes descriptors of width D
    (<= 256; the wrappers pad other widths to a multiple of 32)."""
    if not 0 < D <= MAX_WIDTH:
        raise ValueError(f"{name}: descriptor width {D} outside [1, {MAX_WIDTH}]")


def check_k(k: int, name: str = "knn kernel") -> None:
    """Raise ValueError unless the pooled kernel takes k neighbours (<= 16)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside [1, {MAX_K}] (ROADMAP section 3)")


def knn(desc_q, qid, desc_t, tid, k: int, self_idx=None, compute_dtype: str = "float32"):
    """k nearest targets of each query (ascending distance, ties -> lower index).

    desc_q (Fq, D) / desc_t (Ft, D) float32; qid (Fq,) / tid (Ft,) int32
    image ids with the mask encoding of the module doc; self_idx (Fq,) int32
    or None; the cross term in `compute_dtype` ("float32" or "bfloat16").
    CUDA tensors launch the kernel (D <= 256, zero-padded to a multiple of
    32; k <= 16); CPU tensors take the plain version (any D and k <= Ft).
    """
    tensors = [desc_q, qid, desc_t, tid] + ([] if self_idx is None else [self_idx])
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"knn: tensors on several devices {devs}")
    if desc_q.dtype != torch.float32 or desc_t.dtype != torch.float32:
        raise TypeError("knn: descriptors must be float32")
    if any(t.dtype != torch.int32 for t in tensors[1::2]) or (
        self_idx is not None and self_idx.dtype != torch.int32
    ):
        raise TypeError("knn: ids and self_idx must be int32")
    if desc_q.ndim != 2 or desc_t.ndim != 2 or desc_q.shape[1] != desc_t.shape[1]:
        raise ValueError(f"knn: shapes {tuple(desc_q.shape)} vs {tuple(desc_t.shape)}")
    if not 1 <= k <= desc_t.shape[0]:
        raise ValueError(f"knn: k={k} outside [1, Ft={desc_t.shape[0]}]")
    check_compute_dtype(compute_dtype)
    dev = desc_q.device
    if dev.type == "cpu":
        return knn_plain(desc_q, qid, desc_t, tid, k, self_idx, compute_dtype=compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"knn: unsupported device {dev}")
    check_width(desc_q.shape[1], "knn kernel")
    check_k(k, "knn kernel")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("knn kernel: inputs must be contiguous")
    return _knn_cuda(desc_q, qid, desc_t, tid, k, self_idx, compute_dtype)


def knn_pairs_plain(desc, valid, pairs, k: int = 2, compute_dtype: str = "float32"):
    """Plain PyTorch version of `knn_pairs`: per pair chunk, batched `bmm`
    distances (the cross term in `compute_dtype`, norms in float32),
    invalid targets at BIG, and a STABLE sort (ties keep the lower index).
    Chunks hold about 1 GB of distances, sort values and indices. Returns
    (idx (P, 2, K, k) int32, dist (P, 2, K, k) float32)."""
    N, Kc, _ = desc.shape
    norms = torch.sum(desc * desc, dim=-1)  # (N, K)
    ops = operand(desc, compute_dtype)
    chunk = max(1, _PLAIN_CHUNK_BYTES // (2 * 16 * Kc * Kc))
    pl = pairs.long()
    idx_out, d_out = [], []
    for s in range(0, pl.shape[0], chunk):
        cp = pl[s : s + chunk]
        idx_d, d_d = [], []
        for qi, ti in ((cp[:, 0], cp[:, 1]), (cp[:, 1], cp[:, 0])):
            cross = torch.bmm(ops[qi], ops[ti].transpose(1, 2))
            d = torch.clamp(norms[qi][:, :, None] + norms[ti][:, None, :] - 2.0 * cross, min=0.0)
            d = torch.where(valid[ti][:, None, :], d, torch.full_like(d, BIG))
            vals, order = torch.sort(d, dim=-1, stable=True)
            idx_d.append(order[..., :k].to(torch.int32))
            d_d.append(vals[..., :k])
        idx_out.append(torch.stack(idx_d, 1))
        d_out.append(torch.stack(d_d, 1))
    return torch.cat(idx_out), torch.cat(d_out)


def _knn_pairs_cuda(desc, valid, pairs, k, compute_dtype):
    global pair_launches, bf16_pair_launches
    lib = _build.library()
    desc = pad_width(desc)
    N, Kc, D = desc.shape
    P = pairs.shape[0]
    dev = desc.device
    tag = torch.where(valid, 0, -2).to(torch.int32)
    bf = compute_dtype == "bfloat16"
    norms = torch.empty(bf16_scratch_floats(N * Kc, D) if bf else N * Kc, dtype=torch.float32,
                        device=dev)
    idx = torch.empty((P, 2, Kc, 2), dtype=torch.int32, device=dev)
    dist = torch.empty((P, 2, Kc, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.apst_knn_pairs(
        desc.data_ptr(), tag.data_ptr(), N, Kc, D, pairs.data_ptr(), P, 2,
        int(bf), norms.data_ptr(), idx.data_ptr(), dist.data_ptr(),
        stream,
    )
    _build.check(err, "apst_knn_pairs")
    pair_launches += 1
    bf16_pair_launches += bf
    if k != 2:
        idx, dist = idx[..., :k].contiguous(), dist[..., :k].contiguous()
    return idx, dist


def knn_pairs(desc, valid, pairs, k: int = 2, compute_dtype: str = "float32"):
    """k nearest target slots for every query slot of every pair, both ways.

    desc (N, K, D) float32 descriptor slots per image, valid (N, K) bool,
    pairs (P, 2) int32 image indices. Returns (idx, dist), each
    (P, 2, K, k): [p, 0] is pairs[p, 0] -> pairs[p, 1], [p, 1] the reverse;
    idx are slots of the target image, ascending distance, ties -> lower
    slot. Only invalid targets are masked (BIG); invalid queries keep their
    true neighbours. The cross term in `compute_dtype`. CUDA tensors launch
    the kernel (D <= 256, zero-padded to a multiple of 32; k <= 2; 2 P
    ceil(K / 128) < 2^31 blocks); CPU tensors take the plain version.
    """
    devs = {t.device for t in (desc, valid, pairs)}
    if len(devs) != 1:
        raise ValueError(f"knn_pairs: tensors on several devices {devs}")
    if desc.dtype != torch.float32 or valid.dtype != torch.bool or pairs.dtype != torch.int32:
        raise TypeError("knn_pairs: desc float32, valid bool and pairs int32 expected")
    if desc.ndim != 3 or valid.shape != desc.shape[:2] or pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError(f"knn_pairs: shapes {tuple(desc.shape)}, {tuple(valid.shape)}, "
                         f"{tuple(pairs.shape)}")
    if not 1 <= k <= min(2, desc.shape[1]):
        raise ValueError(f"knn_pairs: k={k} outside [1, min(2, K={desc.shape[1]})]")
    if pairs.numel() and not (0 <= int(pairs.min()) and int(pairs.max()) < desc.shape[0]):
        raise ValueError(f"knn_pairs: image indices outside [0, {desc.shape[0]})")
    check_compute_dtype(compute_dtype)
    dev = desc.device
    if dev.type == "cpu":
        return knn_pairs_plain(desc, valid, pairs, k, compute_dtype=compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"knn_pairs: unsupported device {dev}")
    check_width(desc.shape[2], "knn_pairs kernel")
    blocks = 2 * pairs.shape[0] * -(-desc.shape[1] // 128)
    if not 1 <= blocks < 2**31:
        raise ValueError(f"knn_pairs kernel: {pairs.shape[0]} pairs of {desc.shape[1]} slots "
                         f"need {blocks} blocks, outside [1, 2^31)")
    if not (desc.is_contiguous() and pairs.is_contiguous()):
        raise ValueError("knn_pairs kernel: inputs must be contiguous")
    return _knn_pairs_cuda(desc, valid, pairs, k, compute_dtype)

