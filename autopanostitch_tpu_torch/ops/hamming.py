"""Binary-descriptor (Hamming) matching (port of `ops/hamming.py`).

For bit vectors unpacked to {0,1}^D the Hamming distance is

    ham(a, b) = sum(a) + sum(b) - 2 a.b,

the squared L2 distance, so on the card `hamming_two_nn` runs kernel B1's
pair-list mode at D = nbytes * 8 (exact: every product of {0,1} values is an
integer), with `two_nn`'s masking: invalid targets at BIG, invalid queries'
distances at BIG. Bits are packed least significant first.
"""

from __future__ import annotations

import torch

from autopanostitch_tpu_torch.kernels.knn import knn_pairs
from autopanostitch_tpu_torch.ops import matching as mt


def unpack_bits(packed):
    """(N, nbytes) uint8 -> (N, nbytes * 8) float32 in {0, 1} (LSB first)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).to(torch.float32)


def pack_bits(bits):
    """(N, D) {0,1} -> (N, ceil(D / 8)) uint8 (LSB first)."""
    N, D = bits.shape
    b = torch.nn.functional.pad(bits.to(torch.uint8), (0, (-D) % 8)).reshape(N, -1, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (b << shifts).sum(-1).to(torch.uint8)


def hamming_distance_matrix(bits_a, bits_b):
    """(Ma, D) x (Mb, D) {0,1} float -> (Ma, Mb) Hamming distances."""
    sa = bits_a.sum(-1, keepdim=True)
    sb = bits_b.sum(-1, keepdim=True).T
    return sa + sb - 2.0 * (bits_a @ bits_b.T)


def hamming_two_nn(packed_q, mask_q, packed_t, mask_t):
    """Exact 2-NN under Hamming distance of packed uint8 descriptors.
    Returns (idx1 (Mq,) int32, d1 (Mq,), d2 (Mq,)) float32."""
    return mt.two_nn(unpack_bits(packed_q), mask_q, unpack_bits(packed_t), mask_t)


def match_pair_hamming(packed_a, mask_a, packed_b, mask_b, ratio: float = 0.8,
                       max_matches: int = 512):
    """Binary pair matching: 2-NN Hamming both ways, the ratio on raw
    distances (strict: d1 < r d2), the mutual check and compaction by
    ascending distance. Returns (idx (max_matches, 2) int32, m
    (max_matches,) bool, n () int32)."""
    desc, valid = mt._pair_stack(unpack_bits(packed_a), mask_a, unpack_bits(packed_b), mask_b)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32, device=desc.device)
    idx, dist = knn_pairs(desc.contiguous(), valid, pairs, 2)
    out, m, n = mt._match_from_nn(idx, dist, mask_a[None], ratio, max_matches, float("inf"),
                                  rule="hamming")
    return out[0], m[0], n[0]
