"""Sentinels and chunk types placed in data queues.

An own copy of ``tensorflowonspark_tpu/marker.py``.  ``None`` in a queue
means end-of-feed; the queues carry chunks (lists of records, or a
``ColumnChunk`` of dense per-field arrays), so a marker is told from
data without an isinstance check on every record.
"""


class Marker:
    """Base class for data-queue sentinels."""


class EndPartition(Marker):
    """Marks the end of one input partition (flush a partial batch)."""

    def __repr__(self):
        return "EndPartition()"


class ColumnChunk:
    """A feed chunk in columnar form: one dense array per field instead
    of a list of row tuples.

    The feeder turns all-numeric row chunks into these
    (``node._make_chunk_encoder`` through ``recordio.marshal``), and the
    ring writes their columns as raw bytes, so a chunk costs no pickling
    of its values and the trainer slices batches out of the columns with
    no per-record Python work.
    """

    __slots__ = ("spec", "columns", "shapes", "meta")

    def __init__(self, spec, columns, shapes=None, meta=None):
        self.spec = spec          # [(dtype_code, width), ...]
        self.columns = columns    # tuple of np.ndarray, one per field
        # per field, the trailing shape of an n-D field that the feeder
        # flattened to a width column (an image's (H, W, C)), else None;
        # None overall when no field was flattened.  Consumers reshape
        # views: the round trip copies nothing
        self.shapes = shapes
        # a small tag riding the wire with the chunk: BARE when each
        # record was a bare array and not a tuple of fields (the feeder's
        # chunks), ("split", sid, seq, nblocks) on a chunk of dynamic
        # split dispatch (the data service's, whose records are named
        # columns and never bare), so that DataFeed drops the prefix of
        # a re-served split it already consumed; None otherwise
        self.meta = meta

    def __getstate__(self):
        return (self.spec, self.columns, self.shapes, self.meta)

    def __setstate__(self, state):
        self.spec, self.columns, self.shapes = state[:3]
        self.meta = state[3] if len(state) > 3 else None

    def __len__(self):
        return len(self.columns[0]) if self.columns else 0

    def __repr__(self):
        return f"ColumnChunk(n={len(self)}, spec={self.spec})"


# ``ColumnChunk.meta`` of a chunk whose records were bare arrays (one
# token sequence a record, not a tuple of fields): its one column holds
# them, and row consumers get each record back as an array, not a tuple
BARE = ("bare",)

# first element of a split tag (``("split", sid, seq, nblocks)``): one
# namespace with BARE's, so the two tags never collide
SPLIT = "split"


def split_tag(sid, seq):
    """The tag of chunk ``seq`` of split ``sid``."""
    return (SPLIT, tuple(sid), int(seq), int(seq) + 1)


def is_split_tag(meta):
    """True for a ``ColumnChunk.meta`` that :func:`split_tag` made."""
    return isinstance(meta, tuple) and len(meta) == 4 and meta[0] == SPLIT
