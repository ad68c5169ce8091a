"""Sentinels placed in data queues.

An own copy of ``tensorflowonspark_tpu/marker.py``'s markers (the
columnar ``ColumnChunk`` comes with the native marshal, which the port
does not have).  ``None`` in a queue means end-of-feed; the queues carry
batches (lists of records), so a marker is told from data without an
isinstance check on every record.
"""


class Marker:
    """Base class for data-queue sentinels."""


class EndPartition(Marker):
    """Marks the end of one input partition (flush a partial batch)."""

    def __repr__(self):
        return "EndPartition()"
