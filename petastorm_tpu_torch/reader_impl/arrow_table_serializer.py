"""Arrow IPC stream serializer of the process pool: a pyarrow Table crosses
the ring without a pickle and without a copy on the consumer's side.

``serialize`` returns the output stream's own buffer (the ring writes any
buffer). ``deserialize`` reads the record batches as views over its input:
``aliases_input = True`` tells the pool that a result may view ring
memory, so it pins the record with a
:class:`~petastorm_tpu_torch.reader_impl.shm_ring.SegmentClaim` until the
last view is gone.

The stream is preceded by :data:`LEAD` zero bytes. A ring record's payload
starts 5 bytes past an 8-byte boundary (a 4-byte length, then the 1-byte
tag), and Arrow pads every buffer to 8 bytes within its stream, so the lead
puts the stream, and with it every column, on an 8-byte boundary of the
ring.

In deterministic mode the workers publish
:class:`~petastorm_tpu_torch.reader_impl.epoch_plan.OrderedUnit` envelopes.
The unit's ``epoch:position:kind`` rides as schema metadata of the table
(an ``empty`` or ``skip`` unit is a table with no columns), under the JAX
package's key, so the stream and its zero-copy reading stay the same.
"""
import pyarrow as pa

from petastorm_tpu_torch.reader_impl.epoch_plan import OrderedUnit

#: Zero bytes before the stream: 8 - (4-byte length + 1-byte tag).
LEAD = 3

#: Schema-metadata key carrying ``b"{epoch}:{position}:{kind}"``.
_ORDERED_META_KEY = b"petastorm_tpu.ordered"


class ArrowTableSerializer:
    #: Deserialized tables view the input buffer.
    aliases_input = True

    def serialize(self, payload):
        if isinstance(payload, OrderedUnit):
            table = payload.payload if payload.kind == "data" else pa.table({})
            meta = dict(table.schema.metadata or {})
            meta[_ORDERED_META_KEY] = (f"{payload.context[0]}:{payload.context[1]}:"
                                       f"{payload.kind}".encode())
            table = table.replace_schema_metadata(meta)   # no data is copied
        else:
            table = payload
        sink = pa.BufferOutputStream()
        sink.write(b"\0" * LEAD)
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.getvalue()

    def deserialize(self, serialized):
        """The table of a serialized stream (bytes, a memoryview or a
        ``pa.Buffer``), viewing it, or the ``OrderedUnit`` it carries."""
        table = pa.ipc.open_stream(pa.py_buffer(serialized)[LEAD:]).read_all()
        meta = table.schema.metadata
        if meta and _ORDERED_META_KEY in meta:
            epoch, pos, kind = meta[_ORDERED_META_KEY].decode().split(":")
            return OrderedUnit((int(epoch), int(pos)), kind=kind,
                               payload=table if kind == "data" else None)
        return table
