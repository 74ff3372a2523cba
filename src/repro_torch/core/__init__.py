"""IntersectX stream ISA on torch tensors: the Stream type, the Table I ops,
and the batched and nested forms (the counterpart of ``repro.core``)."""
from . import isa
from .batch import batch_inter, batch_inter_count, batch_sub, batch_sub_count, batch_vinter
from .nested import s_nestinter
from .stream import (LANE, SENTINEL, Stream, StreamTable, empty_stream, make_stream,
                     round_capacity, stream_from_slice, to_host)

__all__ = [
    "LANE", "SENTINEL", "Stream", "StreamTable", "empty_stream", "make_stream",
    "round_capacity", "stream_from_slice", "to_host", "isa",
    "batch_inter", "batch_inter_count", "batch_sub", "batch_sub_count",
    "batch_vinter", "s_nestinter",
]
