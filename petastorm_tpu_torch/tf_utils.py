"""TensorFlow adapter: this package's readers -> ``tf.data.Dataset`` (and
TF1 graph tensors), the counterpart of the JAX package's ``tf_utils``.

TensorFlow is imported inside the functions, so the package imports without
it. Types follow the reference's rules: Decimal -> string, datetime64 ->
int64 nanoseconds, uint16 -> int32, uint32 -> int64; a batched reader's
object columns of equal-shape rows are stacked into one array.

* :func:`make_petastorm_dataset`: row readers yield one record dict a row,
  batched readers one dict of column arrays a row group (``unbatch()`` /
  ``batch()`` to re-batch), NGram readers ``{offset: namedtuple}`` windows
  (dense NGram readers ``{name: (length, ...)}``);
* :func:`tf_tensors`: graph-mode tensors through ``tf.compat.v1.py_func``,
  optionally behind a ``RandomShuffleQueue``.
"""
from __future__ import annotations

from decimal import Decimal

import numpy as np


def _tf():
    import tensorflow as tf
    return tf


def _sanitize_value(value):
    """Decimal -> str, datetime64 -> ns int64, None -> error upstream."""
    if isinstance(value, Decimal):
        return str(value)
    if isinstance(value, np.datetime64):
        return value.astype("datetime64[ns]").astype(np.int64)
    if isinstance(value, np.ndarray):
        if value.dtype.kind == "M":
            return value.astype("datetime64[ns]").astype(np.int64)
        if value.dtype == object and value.size and isinstance(value.flat[0], Decimal):
            return np.array([str(x) for x in value.flat], dtype=str).reshape(value.shape)
    return value


def _densify(value):
    """Stack an object array of uniform per-row vectors into one matrix
    (parity: reference arrow_reader_worker.py:72-75 vstacks list columns).
    Ragged columns stay as-is and surface TF's conversion error."""
    if isinstance(value, np.ndarray) and value.dtype == object and value.size:
        try:
            return np.stack([np.asarray(v) for v in value])
        except (ValueError, TypeError):
            return value
    return value


def _tf_dtype_for(numpy_dtype):
    tf = _tf()
    if numpy_dtype in (str, np.str_, bytes, np.bytes_):
        return tf.string
    if numpy_dtype is Decimal:
        return tf.string
    npdt = np.dtype(numpy_dtype)
    if npdt.kind == "M":
        return tf.int64
    # TF has no uint16/uint32 kernels for many ops; promote like the reference.
    if npdt == np.uint16:
        return tf.int32
    if npdt == np.uint32:
        return tf.int64
    return tf.as_dtype(npdt)


def _promote(value, numpy_dtype):
    npdt = None
    try:
        npdt = np.dtype(numpy_dtype)
    except TypeError:
        return value
    if npdt == np.uint16:
        return np.asarray(value).astype(np.int32)
    if npdt == np.uint32:
        return np.asarray(value).astype(np.int64)
    return value


def _ngram_views(reader):
    """Per-offset schema views of an NGram reader, in offset order."""
    ngram = reader.ngram
    return {off: ngram.get_schema_at_timestep(reader.schema, off)
            for off in sorted(ngram.fields)}


def _make_ngram_dataset(reader):
    """NGram readout as ``tf.data.Dataset`` of ``{offset: namedtuple}``
    structures (parity: reference tf_utils.py:140-199,408-437 — which
    flattens/unflattens through TF1 plumbing; tf.data's structure support
    handles the nested form directly)."""
    tf = _tf()
    if getattr(reader.ngram, "dense", False):
        # Dense NGram samples are already {name: (length, *shape) array};
        # expose them as a flat dict dataset with the window axis leading.
        length = reader.ngram.length
        view = reader.ngram.get_schema_at_timestep(
            reader.schema, min(reader.ngram.fields))
        signature = {
            name: tf.TensorSpec(
                shape=[length] + [None if d is None else d for d in f.shape],
                dtype=_tf_dtype_for(f.numpy_dtype))
            for name, f in view.fields.items()}

        def dense_generator():
            if reader.last_row_consumed:
                reader.reset()
            for sample in reader:
                yield {name: _promote(_sanitize_value(sample[name]),
                                      view.fields[name].numpy_dtype)
                       for name in signature}

        return tf.data.Dataset.from_generator(dense_generator,
                                              output_signature=signature)
    views = _ngram_views(reader)
    signature = {}
    for off, view in views.items():
        specs = {}
        for name, f in view.fields.items():
            specs[name] = tf.TensorSpec(
                shape=[None if d is None else d for d in f.shape],
                dtype=_tf_dtype_for(f.numpy_dtype))
        signature[off] = view.namedtuple(**specs)

    def generator():
        if reader.last_row_consumed:
            reader.reset()
        for sample in reader:
            out = {}
            for off, view in views.items():
                out[off] = view.namedtuple(**{
                    name: _promote(_sanitize_value(getattr(sample[off], name)),
                                   f.numpy_dtype)
                    for name, f in view.fields.items()})
            yield out

    return tf.data.Dataset.from_generator(generator, output_signature=signature)


def make_petastorm_dataset(reader):
    """Wrap a reader as ``tf.data.Dataset`` (parity: reference :336).

    Row readers yield one flat record dict per sample; batch readers yield
    one dict of arrays per row group (re-batch with ``dataset.unbatch()`` /
    ``batch()``); NGram readers yield ``{offset: namedtuple}`` windows.
    """
    tf = _tf()
    schema = reader.schema
    if getattr(reader, "ngram", None) is not None:
        return _make_ngram_dataset(reader)

    names = list(schema.fields.keys())
    signature = {}
    for name in names:
        f = schema.fields[name]
        shape = tuple(d for d in f.shape)
        if reader.batched_output:
            shape = (None,) + shape
        signature[name] = tf.TensorSpec(
            shape=[None if d is None else d for d in shape],
            dtype=_tf_dtype_for(f.numpy_dtype), name=name)

    def generator():
        if reader.last_row_consumed:
            reader.reset()
        for sample in reader:
            out = {}
            for name in names:
                v = getattr(sample, name)
                if reader.batched_output:
                    v = _densify(v)
                # Sanitize AFTER densify: a stacked datetime64/Decimal matrix
                # still needs its int64/string conversion.
                v = _sanitize_value(v)
                out[name] = _promote(v, schema.fields[name].numpy_dtype)
            yield out

    return tf.data.Dataset.from_generator(generator, output_signature=signature)


def tf_tensors(reader, shuffling_queue_capacity: int = 0, min_after_dequeue: int = 0):
    """Graph-mode tensors via ``tf.compat.v1.py_func`` (parity: reference
    :269; ngram readout :408-437). Requires TF1-style graph execution.

    Plain readers return one schema namedtuple of tensors; NGram readers
    return ``{offset: namedtuple}``."""
    tf = _tf()
    schema = reader.schema
    if getattr(reader, "ngram", None) is not None:
        if getattr(reader.ngram, "dense", False):
            raise TypeError(
                "tf_tensors (TF1 graph mode) does not support dense NGram "
                "readers; use make_petastorm_dataset, which yields "
                "{name: (length, ...)} tensors directly")
        views = _ngram_views(reader)
        flat = [(off, name, f) for off, view in views.items()
                for name, f in view.fields.items()]

        def dequeue():
            sample = next(reader)
            return [np.asarray(_promote(_sanitize_value(getattr(sample[off], name)),
                                        f.numpy_dtype))
                    for off, name, f in flat]
    else:
        names = list(schema.fields.keys())
        flat = [(None, n, schema.fields[n]) for n in names]

        def dequeue():
            sample = next(reader)
            values = ((_densify(getattr(sample, n)) for n in names)
                      if reader.batched_output else
                      (getattr(sample, n) for n in names))
            return [np.asarray(_promote(_sanitize_value(v),
                                        schema.fields[n].numpy_dtype))
                    for n, v in zip(names, values)]

    def _static_shape(f):
        """Per-sample shape; batch readers prepend an unknown batch dim."""
        if any(d is None for d in f.shape):
            return None
        if reader.batched_output:
            return [None] + list(f.shape)
        return list(f.shape)

    dtypes = [_tf_dtype_for(f.numpy_dtype) for _, _, f in flat]
    tensors = tf.compat.v1.py_func(dequeue, [], dtypes)
    for t, (_, _, f) in zip(tensors, flat):
        shape = _static_shape(f)
        if shape is not None:
            t.set_shape(shape)
    if shuffling_queue_capacity > 0:
        queue = tf.queue.RandomShuffleQueue(
            shuffling_queue_capacity, min_after_dequeue,
            dtypes=dtypes, name="petastorm_tpu_torch_shuffling_queue")
        enqueue = queue.enqueue(tensors)
        tf.compat.v1.train.add_queue_runner(
            tf.compat.v1.train.QueueRunner(queue, [enqueue]))
        tensors = queue.dequeue()
        if not isinstance(tensors, (list, tuple)):
            tensors = [tensors]  # single-component dequeue returns a bare Tensor
        for t, (_, _, f) in zip(tensors, flat):
            shape = _static_shape(f)
            if shape is not None:
                t.set_shape(shape)
    if getattr(reader, "ngram", None) is not None:
        by_offset = {}
        for t, (off, name, _) in zip(tensors, flat):
            by_offset.setdefault(off, {})[name] = t
        return {off: views[off].namedtuple(**cols)
                for off, cols in by_offset.items()}
    return schema.namedtuple(**{name: t for t, (_, name, _) in zip(tensors, flat)})
