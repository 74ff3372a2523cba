"""Bitmap intersection path — a hand-written CUDA kernel
(``csrc/bitmap.cu``) in place of the Pallas ``bitmap_and_count_pallas`` of
``repro/kernels/bitmap.py``.

A neighbour list becomes an adjacency bitmap, 32 keys an int32 word
(``keys_to_bitmap``, plain torch on either device, as it is jnp in the JAX
package); then |A ∩ B| is an AND and a popcount a word
(``bitmap_and_count``): O(V/32) whatever the lists' lengths, which wins
over the sorted-row merge where both rows are dense in the key space.

The wrapper picks its path by the device of its tensors: a CPU tensor takes
the plain version (``bitmap_and_count_ref``, a popcount in torch ops —
PyTorch has none); a CUDA tensor launches the kernel on the current stream,
or raises. ``bitmap_and_count.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.stream import SENTINEL

from .build import launch

TW = 256  # words a row is padded to a multiple of (the JAX package's tile)


def keys_to_bitmap(keys: torch.Tensor, num_bits: int) -> torch.Tensor:
    """(B, cap) SENTINEL-padded sorted keys -> (B, W) int32 bitmap words,
    W = ceil(num_bits / 32) padded to a multiple of ``TW``.

    Key k sets bit k % 32 of word k // 32. Keys are unique per row, so the
    scatter-add of disjoint single bits is exactly a bitwise OR, bit 31
    (INT32_MIN) included. A key outside [0, W·32) is dropped, as the JAX
    package's ``.at[].add`` drops it: it lands in a dump column past the end
    (an out-of-range CUDA scatter index is a device assert)."""
    words = -(-num_bits // 32)
    w_pad = -(-words // TW) * TW
    valid = (keys != SENTINEL) & (keys >= 0) & (keys < w_pad * 32)
    word = torch.where(valid, keys // 32, w_pad).long()
    bit = torch.where(valid, torch.bitwise_left_shift(torch.ones_like(keys), keys % 32), 0)
    out = torch.zeros((keys.shape[0], w_pad + 1), dtype=torch.int32, device=keys.device)
    out.scatter_add_(1, word, bit.to(torch.int32))
    return out[:, :w_pad].contiguous()


def bitmap_and_count_ref(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``bitmap_and_count``: a SWAR popcount of each
    32-bit AND, in int64 lanes, summed per row."""
    x = (a_words & b_words).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(dim=1).to(torch.int32)


def _check(a_words, b_words) -> None:
    """Raise on anything the kernel does not take."""
    for name, t in (("a_words", a_words), ("b_words", b_words)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() \
                or t.shape != a_words.shape or t.device != a_words.device:
            raise ValueError(f"{name} must be a contiguous {tuple(a_words.shape)} int32 "
                             f"tensor on {a_words.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if a_words.shape[1] % TW or not a_words.shape[1]:
        raise ValueError(f"W = {a_words.shape[1]} words is not a positive multiple of "
                         f"{TW} (keys_to_bitmap pads to it)")
    if a_words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bitmap kernel for device {a_words.device}")
    if a_words.device.type == "cuda" and (a_words.data_ptr() % 16 or b_words.data_ptr() % 16):
        raise ValueError("the bitmap kernel reads 16-byte words: rows must start "
                         "16-byte aligned")


def bitmap_and_count(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """counts[i] = Σ_w popcount(A_i[w] & B_i[w]) -> (B,) int32."""
    _check(a_words, b_words)
    if a_words.device.type == "cpu":
        return bitmap_and_count_ref(a_words, b_words)
    counts = torch.empty(a_words.shape[0], dtype=torch.int32, device=a_words.device)
    if a_words.shape[0]:
        launch("bitmap", "repro_bitmap_and_count", a_words.device,
               (a_words, b_words, counts), a_words.shape)
        bitmap_and_count.launches += 1
    return counts


bitmap_and_count.launches = 0
