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
"""
import pyarrow as pa

#: Zero bytes before the stream: 8 - (4-byte length + 1-byte tag).
LEAD = 3


class ArrowTableSerializer:
    #: Deserialized tables view the input buffer.
    aliases_input = True

    def serialize(self, table: pa.Table):
        sink = pa.BufferOutputStream()
        sink.write(b"\0" * LEAD)
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.getvalue()

    def deserialize(self, serialized) -> pa.Table:
        """The table of a serialized stream (bytes, a memoryview or a
        ``pa.Buffer``), viewing it."""
        return pa.ipc.open_stream(pa.py_buffer(serialized)[LEAD:]).read_all()
