"""Pickle payload serializer of the process pool (reference
petastorm/reader_impl/pickle_serializer.py:18)."""
import pickle


class PickleSerializer:
    """``pickle.loads`` copies everything out of its input, so a result
    never aliases the ring record it was read from: the pool deserializes
    straight from the mapped record and releases it at once."""

    aliases_input = False

    def serialize(self, rows) -> bytes:
        return pickle.dumps(rows, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, serialized):
        return pickle.loads(serialized)
