"""Plain torch versions of every kernel, under the names of
``repro.kernels.ref``: the kernels must match them bit for bit (integer
counts, marks and rows) or to f32 tolerance (S_VINTER's sums, whose order
differs). Re-exported from where they live beside their kernels."""
from __future__ import annotations

from repro_torch.core.batch import batch_inter

from .bitmap import bitmap_and_count_ref, keys_to_bitmap
from .intersect import intersect_count_ref, intersect_mark_ref
from .svinter import vinter_ref


def intersect_rows_ref(a, b, bounds=None, out_cap=None):
    """Materialised bounded S_INTER rows -> (rows, counts)."""
    return batch_inter(a, b, bounds, out_cap=out_cap)


__all__ = [
    "intersect_count_ref", "intersect_mark_ref", "intersect_rows_ref",
    "vinter_ref", "bitmap_and_count_ref", "keys_to_bitmap",
]
